"""lr_scan_idle_ms: ms per traced trait in which the card sat idle under the
low-rank scan's own code: the route outside its parts (span
``lowrank_scan``), a superblock's lattice and epilogue (``lr_lattice``), a
resident chunk outside its upload (``superblock``, ``kernels``,
``to_host``) and the concatenation of the results (``results``); each idle
stretch inside a step, cut at the program's spans, goes to the innermost
one. None where the program has no ``lowrank_scan`` span."""

from portbench import program_spans

NAMES = ("lowrank_scan", "lr_lattice", "superblock", "kernels", "to_host", "results")


def read(run):
    tr = program_spans._device_trace(run)
    if tr is None or "lowrank_scan" not in program_spans._spans(tr, ("lowrank_scan",))[0]:
        return None
    return program_spans.idle_ms(run, NAMES)
