"""fc_scans_per_trait: the LM scans of the whole panel per traced trait, as
the program counts them (``lm.scans``, one per ``models.lm.lm_scan_multi``
call) while the profiler recorded: FarmCPU's loops plus its final scan."""

from portbench import program_spans


def read(run):
    return program_spans.counted(run, "lm.scans")
