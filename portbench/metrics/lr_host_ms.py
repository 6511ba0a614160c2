"""lr_host_ms: ms per traced trait of the low-rank route's host float64
work before its scan: the program's spans ``lr_rotate_y``
(``models.fastlmm.make_rotated_lr``) and ``lr_null`` (the null REML fit
and the switch test, whose spans nest), the union of their intervals."""

import numpy as np

from portbench import program_spans


def read(run):
    tr = program_spans._device_trace(run)
    if tr is None:
        return None
    _, starts, ends = program_spans._spans(tr, ("lr_rotate_y", "lr_null"))
    if not len(starts):
        return None
    order = np.argsort(starts, kind="stable")
    total, reach = 0, None
    for s, e in zip(starts[order], ends[order]):
        s, e = int(s), int(e)
        if reach is None or s > reach:
            total, reach = total + e - s, e
        elif e > reach:
            total, reach = total + e - reach, e
    return 1e-6 * total / program_spans.traced_traits(run)
