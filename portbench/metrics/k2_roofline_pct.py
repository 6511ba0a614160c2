"""k2_roofline_pct: K2 (``lattice_wgmma``, csrc/lattice.cu) as a share of
its roofline bound: the bound of every step's λ lattice (m SNPs, n
samples, G grid points, T traits, p covariates) over K2's summed device
time in the trace."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    secs, launches = run.trace.seconds_of("lattice_wgmma")
    if not launches:
        return None
    sh = run.shape
    steps = sum(1 for s in run.traced if s.tests)
    ops, nbytes = roofline.k2(sh["m"], sh["n"], sh["G"], sh["T"], sh["p"])
    return roofline.share_pct(steps * ops, steps * nbytes, secs)
