"""grams_roofline_pct: the GRAMMAR scan's device work as a share of the
roofline bound of its LM grams (the packed panel read once, 2 n m (p+2)
operations a trait): the bound of every traced step over the summed time of the
kernels that started inside the steps."""

from portbench import roofline


def read(run):
    if run.trace is None:
        return None
    secs = run.trace.kernel_seconds_in_steps()
    sh = run.shape
    steps = sum(1 for s in run.traced if s.tests)
    ops, nbytes = roofline.lm_grams(sh["m"], sh["n"], sh["p"], sh["T"])
    return roofline.share_pct(steps * ops, steps * nbytes, secs)
