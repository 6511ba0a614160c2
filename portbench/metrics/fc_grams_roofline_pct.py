"""fc_grams_roofline_pct: FarmCPU's device work as a share of the roofline
bound of the LM grams of its scans: per scan the packed panel read once
and 2 n m (p + 2) operations for a design of width p, summed over the
traced scans (the program's ``lm.scans``, and ``lm.design_cols`` for the
summed p), over the summed time of the kernels that started inside the
steps. None where the program does not count its scans."""

from portbench import program_spans, roofline


def read(run):
    scans = program_spans.counted(run, "lm.scans")
    cols = program_spans.counted(run, "lm.design_cols")
    if not scans or cols is None:
        return None
    traits = program_spans.traced_traits(run)
    S, P = scans * traits, cols * traits
    sh = run.shape
    # the operations are linear in p: S scans of the mean width count the sum
    ops, nbytes = roofline.lm_grams(sh["m"], sh["n"], P / S, 1)
    return roofline.share_pct(S * ops, S * nbytes, run.trace.kernel_seconds_in_steps())
