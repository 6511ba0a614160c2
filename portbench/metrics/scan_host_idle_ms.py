"""scan_host_idle_ms: ms per traced trait in which the card sat idle under
the dense scan's own host code: the route outside its parts (span
``lmm_scan``), a resident chunk outside its upload, kernels and copy back
(``superblock``), and the host epilogue (``results``); each idle stretch
inside a step, cut at the program's spans, goes to the innermost one."""

from portbench import program_spans


def read(run):
    return program_spans.idle_ms(run, ("lmm_scan", "superblock", "results"))
