"""Stage progress + resource reporting.

Reference analog: per-stage wall/CPU/peak-RSS logging
(workflow_model_packed.py:6806-6820) and rich progress panels
(script/_common/progress.py). Here: a ``stage()`` context manager that
logs wall time, process CPU time and RSS delta per pipeline stage, and a
simple rate logger for block streams.
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("janusx_tpu.progress")


def _rss_mb() -> float:
    try:
        with open("/proc/self/status") as fh:
            for line in fh:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0
    except OSError:
        pass
    return float("nan")


@contextlib.contextmanager
def stage(name: str, logger: logging.Logger | None = None):
    from janusx_tpu_torch import config

    if not config.knob("JX_TPU_PROGRESS"):
        yield
        return
    lg = logger or log
    t0 = time.monotonic()
    c0 = time.process_time()
    r0 = _rss_mb()
    lg.info("[stage] %s ...", name)
    try:
        yield
    finally:
        lg.info(
            "[stage] %s done: wall=%.2fs cpu=%.2fs rss=%.0fMB (%+.0fMB)",
            name, time.monotonic() - t0, time.process_time() - c0,
            _rss_mb(), _rss_mb() - r0,
        )


class RateLogger:
    """Log throughput every ``interval`` seconds for long block streams."""

    def __init__(self, total: int, unit: str = "SNPs", interval: float = 10.0,
                 logger: logging.Logger | None = None):
        self.total = total
        self.unit = unit
        self.interval = interval
        self.lg = logger or log
        self.t0 = time.monotonic()
        self.last = self.t0
        self.done = 0

    def update(self, n: int) -> None:
        self.done += n
        now = time.monotonic()
        if now - self.last >= self.interval or self.done >= self.total:
            rate = self.done / max(now - self.t0, 1e-9)
            self.lg.info(
                "%d/%d %s (%.0f %s/s)",
                self.done, self.total, self.unit, rate, self.unit,
            )
            self.last = now
