"""k1_roofline_pct: K1 (``decode_rotate_wgmma``, csrc/rotate.cu) as a share
of its roofline bound: the bound of every traced step's rotation (m SNPs, n
samples, the N basis columns; once per step whatever its traits) over
K1's summed device time in the trace."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    secs, launches = run.trace.seconds_of("decode_rotate")
    if not launches:
        return None
    sh = run.shape
    steps = sum(1 for s in run.traced if s.tests)
    ops, nbytes = roofline.k1(sh["m"], sh["n"], sh["N"])
    return roofline.share_pct(steps * ops, steps * nbytes, secs)
