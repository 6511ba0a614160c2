"""What the program's own spans and counters say in a traced run.

The port marks its layers with spans named ``jx.<name>``
(``janusx_tpu_torch/utils/trace.py``): ``record_function`` spans while a
profiler records, so they are host events of the main thread in
``TraceData``, on the device's clock. Its counters are read from the
program's table of what was counted while the profiler recorded (the
harness traces once a run).

A reading is per traced trait: the traced window's total over the traits
of its steps that completed. Every reader gives None where the trace holds
no device operation, or where the program has no such span or counter (a
program older than its spans).
"""

from __future__ import annotations

import numpy as np

PREFIX = "jx."
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel")


def traced_traits(run) -> int:
    return sum(s.traits for s in run.traced if s.tests)


def _device_trace(run):
    """The run's trace if it saw the device work, else None."""
    tr = run.trace
    if tr is None or not len(tr.dev_names) or not traced_traits(run):
        return None
    return tr


def _in_steps(tr, t: np.ndarray) -> np.ndarray:
    inside = np.zeros(len(t), bool)
    for a, b in tr.steps:
        inside |= (t >= a) & (t <= b)
    return inside


def _spans(tr, names=None) -> tuple[list, np.ndarray, np.ndarray]:
    """The program's spans that start inside a step (``names``: only
    those), as (names without the prefix, starts, ends)."""
    idx = np.array([i for i, n in enumerate(tr.host_names) if n.startswith(PREFIX)
                    and (names is None or n[len(PREFIX):] in names)], np.int64)
    idx = idx[_in_steps(tr, tr.host_start[idx])]
    return ([tr.host_names[i][len(PREFIX):] for i in idx], tr.host_start[idx],
            tr.host_end[idx])


def _innermost(names: list, starts: np.ndarray, ends: np.ndarray) -> list:
    """The spans, which nest, cut into (start, end, name) pieces, each
    named by the innermost span open over it; time under no span is left
    out."""
    order = sorted(range(len(names)), key=lambda i: (starts[i], -ends[i]))
    pieces, stack, t = [], [], 0  # stack: (name, end)
    for i in order:
        s = int(starts[i])
        while stack and stack[-1][1] <= s:
            name, e = stack.pop()
            pieces.append((t, e, name))
            t = e
        if stack:
            pieces.append((t, s, stack[-1][0]))
        # a span ends no later than its parent
        stack.append((names[i], min(int(ends[i]), stack[-1][1]) if stack else int(ends[i])))
        t = s
    while stack:
        name, e = stack.pop()
        pieces.append((t, e, name))
        t = e
    return [p for p in pieces if p[1] > p[0]]


def _overlap(xs: list, ys: list):
    """For sorted lists of disjoint (start, end, ...) intervals: each
    overlap of an x with a y, as (start, end, y)."""
    i = j = 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            yield a, b, ys[j]
        if xs[i][1] <= ys[j][1]:
            i += 1
        else:
            j += 1


def idle_by_span(tr) -> dict:
    """ns of device idle time inside the steps, by the innermost program
    span open over it (None: under no span). Each idle stretch of the
    device's union is cut exactly at the spans' edges."""
    starts, ends = tr._union()
    a = np.r_[tr.t0, ends].astype(np.int64)
    b = np.r_[starts, tr.t1].astype(np.int64)
    idle = [(int(x), int(y)) for x, y in zip(a, b) if y > x]
    steps = sorted((int(x), int(y)) for x, y in tr.steps)
    idle = [(s, e) for s, e, _ in _overlap(idle, steps)]
    pieces = _innermost(*_spans(tr))
    out: dict = {}
    covered = 0
    for s, e, piece in _overlap(idle, pieces):
        out[piece[2]] = out.get(piece[2], 0) + (e - s)
        covered += e - s
    out[None] = sum(e - s for s, e in idle) - covered
    return out


def idle_ms(run, names: tuple) -> float | None:
    """ms per traced trait of device idle time put down to ``names``."""
    tr = _device_trace(run)
    if tr is None or not len(_spans(tr)[0]):
        return None
    idle = idle_by_span(tr)
    return 1e-6 * sum(idle.get(n, 0) for n in names) / traced_traits(run)


def span_ms(run, name: str) -> float | None:
    """ms per traced trait inside the span ``name``."""
    tr = _device_trace(run)
    if tr is None:
        return None
    _, s, e = _spans(tr, (name,))
    return 1e-6 * float((e - s).sum()) / traced_traits(run) if len(s) else None


def launches_in(run, name: str) -> float | None:
    """Kernel launches issued (host events ``cudaLaunchKernel*`` /
    ``cuLaunchKernel*``) inside the span ``name``, per traced trait."""
    tr = _device_trace(run)
    if tr is None:
        return None
    _, s, e = _spans(tr, (name,))
    if not len(s):
        return None
    hit = np.array([n.startswith(LAUNCHES) for n in tr.host_names], bool)
    t = tr.host_start[hit]
    inside = np.zeros(len(t), bool)
    for a, b in zip(s, e):
        inside |= (t >= a) & (t <= b)
    return float(inside.sum()) / traced_traits(run)


def counted(run, name: str) -> float | None:
    """The program's count of ``name`` while the profiler recorded, per
    traced trait."""
    if _device_trace(run) is None:
        return None
    try:
        from janusx_tpu_torch.utils import trace
    except ImportError:
        return None
    n = trace.counts(profiled=True).get(name)
    return None if n is None else n / traced_traits(run)
