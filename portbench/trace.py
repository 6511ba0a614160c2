"""The traced run: a ``torch.profiler`` trace of the measured window, read
into device intervals, the harness's own spans and the host's ops.

``torch.profiler`` records every kernel the process launches through CUPTI,
the ``ctypes``-launched kernels of the port included, and the host's
PyTorch ops and ``record_function`` spans on the same clock. The harness
marks each step with the span ``portbench.step`` and its calls into the
program with ``portbench.<call>``.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

SPAN = "portbench."


def _ns(ev, what: str) -> int:
    f = getattr(ev, f"{what}_ns", None)
    return int(f()) if f is not None else int(getattr(ev, f"{what}_us")() * 1000)


@dataclass
class TraceData:
    """Device ops (name, start, end), host events and the steps, in ns of the
    profiler's clock, cut to the traced window [t0, t1]."""

    t0: int
    t1: int
    dev_names: list
    dev_start: np.ndarray
    dev_end: np.ndarray
    host_names: list
    host_start: np.ndarray
    host_end: np.ndarray
    steps: list = field(default_factory=list)  # (start, end) of each step

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-9

    def _union(self) -> tuple[np.ndarray, np.ndarray]:
        """The device ops' intervals, clipped to the window and merged:
        (starts, ends) of the busy stretches."""
        s = np.clip(self.dev_start, self.t0, self.t1)
        e = np.clip(self.dev_end, self.t0, self.t1)
        if not len(s):
            return s, e
        order = np.argsort(s, kind="stable")
        s, e = s[order], np.maximum.accumulate(e[order])
        new = np.ones(len(s), bool)
        new[1:] = s[1:] > e[:-1]
        starts = s[new]
        ends = e[np.r_[np.nonzero(new)[0][1:] - 1, len(s) - 1]]
        return starts, ends

    @property
    def busy_s(self) -> float:
        """Seconds of the window in which some operation ran on the device."""
        a, b = self._union()
        return float((b - a).sum()) * 1e-9

    def kernel_mask(self) -> np.ndarray:
        return np.array([not (n.startswith("Memcpy") or n.startswith("Memset"))
                         for n in self.dev_names], bool)

    def seconds_of(self, needle: str) -> tuple[float, int]:
        """Summed device time and count of the ops whose name holds ``needle``."""
        hit = np.array([needle in n for n in self.dev_names], bool)
        return float((self.dev_end[hit] - self.dev_start[hit]).sum()) * 1e-9, int(hit.sum())

    def kernel_seconds_in_steps(self) -> float:
        """Summed time of the kernels that started inside a step."""
        k = self.kernel_mask()
        inside = np.zeros(len(self.dev_names), bool)
        for a, b in self.steps:
            inside |= (self.dev_start >= a) & (self.dev_start <= b)
        sel = k & inside
        return float((self.dev_end[sel] - self.dev_start[sel]).sum()) * 1e-9

    def top_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for name, a, b in zip(self.dev_names, self.dev_start, self.dev_end):
            tot[name] = tot.get(name, 0) + int(b - a)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:k]
        return [[name[:200], v * 1e-9] for name, v in top]

    def _labels(self, mids: np.ndarray) -> list:
        """For each time in ``mids`` (sorted): "<innermost harness span>/<innermost
        host op>" around it, by one sweep over the host events, which nest."""
        order = np.lexsort((self.host_start - self.host_end, self.host_start))
        spans, ops, out, j = [], [], [], 0
        for t in mids:
            while j < len(order) and self.host_start[order[j]] <= t:
                e = order[j]
                (spans if self.host_names[e].startswith(SPAN) else ops).append(e)
                j += 1
            for st in (spans, ops):
                while st and self.host_end[st[-1]] < t:
                    st.pop()
            span = self.host_names[spans[-1]][len(SPAN):] if spans else "outside any span"
            op = self.host_names[ops[-1]] if ops else "python"
            out.append(f"{span}/{op}"[:180])
        return out

    def idle_gaps(self, k: int = 10) -> list:
        """Where the device sat idle: each stretch of the window with nothing
        on the device is named by what the host was doing at its middle
        (harness span / innermost host op), and the stretches are summed
        by name; the k largest sums, "<name> xN" for N stretches."""
        starts, ends = self._union()
        a = np.r_[self.t0, ends].astype(np.int64)
        b = np.r_[starts, self.t1].astype(np.int64)
        keep = b > a
        a, b = a[keep], b[keep]
        tot: dict = {}
        for name, d in zip(self._labels(a + (b - a) // 2), b - a):
            n, s = tot.get(name, (0, 0))
            tot[name] = (n + 1, s + int(d))
        top = sorted(tot.items(), key=lambda kv: -kv[1][1])[:k]
        return [[f"{name} x{n}", s * 1e-9] for name, (n, s) in top]


class Profiler:
    """Start/stop around the window; ``data()`` reads the trace afterwards."""

    def __init__(self):
        import warnings

        from torch.profiler import ProfilerActivity, profile

        warnings.filterwarnings("ignore", message=".*Profiler clears events.*")

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        return self.prof.__exit__(*exc)

    def data(self) -> TraceData:
        from torch.autograd import DeviceType

        events = self.prof.profiler.kineto_results.events()
        dev, host, steps = [], [], []
        main = None
        for ev in events:
            if ev.name() == SPAN + "step":
                main = ev.start_thread_id()
                break
        for ev in events:
            s = _ns(ev, "start")
            e = s + _ns(ev, "duration")
            name = ev.name()
            if ev.device_type() == DeviceType.CUDA:
                # a record_function span shows on the device's timeline too
                if not (name.startswith(SPAN) or ev.is_user_annotation()):
                    dev.append((name, s, e))
            elif ev.start_thread_id() == main:
                host.append((name, s, e))
                if name == SPAN + "step":
                    steps.append((s, e))
        steps.sort()
        t0 = steps[0][0] if steps else 0
        t1 = steps[-1][1] if steps else 0
        arr = lambda xs, i: np.array([x[i] for x in xs], np.int64)
        return TraceData(t0=t0, t1=t1, dev_names=[d[0] for d in dev],
                         dev_start=arr(dev, 1), dev_end=arr(dev, 2),
                         host_names=[h[0] for h in host], host_start=arr(host, 1),
                         host_end=arr(host, 2), steps=steps)
