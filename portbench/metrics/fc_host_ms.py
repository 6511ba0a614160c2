"""fc_host_ms: ms per traced trait of FarmCPU's host stages between its
scans: the program's spans ``fc_map`` (the position key), ``fc_bins`` (a
loop's candidate lead sets), ``fc_rem`` (a set's REM score), ``fc_decode``
(the host decode of pseudo-QTN and lead rows), ``fc_prune`` (the |r| > 0.7
rule) and ``fc_qtn_p`` (the joint model of the pseudo-QTNs), the union of
their intervals (they nest). None where the program has none of them."""

import numpy as np

from portbench import program_spans

NAMES = ("fc_map", "fc_bins", "fc_rem", "fc_decode", "fc_prune", "fc_qtn_p")


def read(run):
    tr = program_spans._device_trace(run)
    if tr is None:
        return None
    _, starts, ends = program_spans._spans(tr, NAMES)
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
