"""The readers of the program's spans and counters (portbench/program_spans.py
and the seven metrics on them) on a hand-built trace: the exact cut of
the device's idle time at the spans' edges, the innermost span taking
each piece, the launches inside ``fit_null``, the spans' durations, the
upload counter, and no reading from a program without spans."""

from __future__ import annotations

import sys

import numpy as np
import pytest

from portbench import manifest as mf
from portbench import program_spans
from portbench.harness import RunRecord, Step
from portbench.trace import TraceData

MS = 1_000_000  # ns


def _trace(dev, host, steps) -> TraceData:
    arr = lambda xs, i: np.array([x[i] for x in xs], np.int64)
    return TraceData(t0=steps[0][0], t1=steps[-1][1], dev_names=[d[0] for d in dev],
                     dev_start=arr(dev, 1), dev_end=arr(dev, 2),
                     host_names=[h[0] for h in host], host_start=arr(host, 1),
                     host_end=arr(host, 2), steps=steps)


def _run(tr, traits=(1, 1)) -> RunRecord:
    traced = [Step(0.0, 1.0, i, t, 1000 * t) for i, t in enumerate(traits)]
    return RunRecord(cell="c", config={}, traffic={}, shape={}, steps=[], window_s=1.0,
                     setup_s=1.0, trace=tr, traced=traced)


def _dense() -> TraceData:
    """Two steps of 100 ms. Step 1: the device busy 10-20 and 60-70 ms;
    ``lmm_scan`` 5-95 holds ``feed`` 15-40 and ``superblock`` 40-90, which
    holds ``upload`` 45-65. Step 2 (200-300): ``fit_null`` 200-250 with
    three launches inside and one after, the device busy 210-290, and
    ``results`` 260-280."""
    dev = [("k1", 10 * MS, 20 * MS), ("Memcpy HtoD", 60 * MS, 70 * MS),
           ("k2", 210 * MS, 290 * MS)]
    host = [("portbench.step", 0, 100 * MS), ("jx.lmm_scan", 5 * MS, 95 * MS),
            ("jx.feed", 15 * MS, 40 * MS), ("jx.superblock", 40 * MS, 90 * MS),
            ("jx.upload", 45 * MS, 65 * MS), ("aten::copy_", 50 * MS, 55 * MS),
            ("portbench.step", 200 * MS, 300 * MS), ("jx.fit_null", 200 * MS, 250 * MS)]
    host += [("cudaLaunchKernel", (201 + i) * MS, (201 + i) * MS + 10) for i in range(3)]
    host += [("cuLaunchKernelEx", 260 * MS, 260 * MS + 10),
             ("jx.results", 260 * MS, 280 * MS)]
    return _trace(dev, host, [(0, 100 * MS), (200 * MS, 300 * MS)])


def test_idle_is_cut_exactly_at_the_spans_edges():
    idle = program_spans.idle_by_span(_dense())
    # step 1's idle: 0-10, 20-60, 70-100; step 2's: 200-210, 290-300
    assert idle == {None: 20 * MS, "lmm_scan": 10 * MS, "feed": 20 * MS,
                    "superblock": 25 * MS, "upload": 15 * MS, "fit_null": 10 * MS}
    assert sum(idle.values()) == 100 * MS


def test_idle_readers_per_trait():
    run = _run(_dense())
    read = lambda name: mf.reader(name)(run)
    assert read("feed_idle_ms") == pytest.approx((20 + 15) / 2)
    assert read("scan_host_idle_ms") == pytest.approx((10 + 25) / 2)


def test_a_stretch_named_at_its_middle_is_not_the_reading():
    """One idle stretch, 20-60 ms, under ``feed`` until 40 and ``superblock``
    after: half goes to each, whatever its middle falls in."""
    dev = [("k", 10 * MS, 20 * MS), ("k", 60 * MS, 100 * MS)]
    host = [("jx.lmm_scan", 0, 100 * MS), ("jx.feed", 15 * MS, 40 * MS),
            ("jx.superblock", 40 * MS, 100 * MS)]
    idle = program_spans.idle_by_span(_trace(dev, host, [(0, 100 * MS)]))
    assert idle == {"lmm_scan": 10 * MS, "feed": 20 * MS, "superblock": 20 * MS, None: 0}


def test_launches_inside_fit_null():
    run = _run(_dense())
    assert mf.reader("null_fit_launches")(run) == pytest.approx(3 / 2)


def test_span_durations_per_trait():
    dev = [("k", 1 * MS, 2 * MS)]
    host = [("jx.splmm_grammar_scan", 0, 90 * MS), ("jx.sparse_null", 1 * MS, 31 * MS),
            ("jx.block_spectral", 1 * MS, 21 * MS), ("jx.gamma", 31 * MS, 41 * MS),
            ("jx.host_p", 60 * MS, 85 * MS), ("jx.sparse_null", 150 * MS, 160 * MS)]
    run = _run(_trace(dev, host, [(0, 100 * MS), (100 * MS, 200 * MS)]), traits=(1, 1))
    assert mf.reader("sparse_null_ms")(run) == pytest.approx(20.0)
    assert mf.reader("gamma_ms")(run) == pytest.approx(5.0)
    assert mf.reader("host_p_ms")(run) == pytest.approx(12.5)
    # a span outside every step is not the run's
    run.trace.steps = [(0, 100 * MS)]
    assert mf.reader("sparse_null_ms")(run) == pytest.approx(15.0)


def test_h2d_reads_the_programs_profiled_count(monkeypatch):
    from janusx_tpu_torch.utils import trace

    monkeypatch.setattr(trace, "counts",
                        lambda profiled=False: {"h2d_bytes": 1_260_000_000} if profiled else {})
    run = _run(_dense())
    assert mf.reader("h2d_mb_per_trait")(run) == pytest.approx(630.0)


def test_no_reading_without_the_programs_spans_or_a_device(monkeypatch):
    """A program older than its spans (no ``jx.*`` events, no trace module)
    or a trace with no device operation: every reader gives None."""
    names = ["h2d_mb_per_trait", "feed_idle_ms", "scan_host_idle_ms", "null_fit_launches",
             "sparse_null_ms", "gamma_ms", "host_p_ms"]
    tr = _dense()
    keep = [i for i, n in enumerate(tr.host_names) if not n.startswith("jx.")]
    old = _trace(list(zip(tr.dev_names, tr.dev_start, tr.dev_end)),
                 [(tr.host_names[i], tr.host_start[i], tr.host_end[i]) for i in keep], tr.steps)
    import janusx_tpu_torch.utils

    monkeypatch.delattr(janusx_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "janusx_tpu_torch.utils.trace", None)
    assert {n: mf.reader(n)(_run(old)) for n in names} == dict.fromkeys(names)
    monkeypatch.undo()
    no_dev = _trace([], [(n, a, b) for n, a, b in zip(tr.host_names, tr.host_start,
                                                      tr.host_end)], tr.steps)
    assert {n: mf.reader(n)(_run(no_dev)) for n in names} == dict.fromkeys(names)
