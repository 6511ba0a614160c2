"""One run of one cell: set-up, a closed-loop window of steps, the metrics,
the check against the plain reference, and the result line.

A step hands the program the next ``traits_per_step`` traits of the
traffic and ends when their p-values are on the host; the next step starts
then. Every step that starts inside ``seconds`` counts, and the window
ends when the last one ends. ``setup_s`` runs from the start of the
process to the first timed step. A traced run runs the same untraced
window, then traces a stretch of ``TRACE_SECONDS`` more steps: the
per-layer readers of the host's clock read the window, those of the
device the trace.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from portbench import compare
from portbench import manifest as mf
from portbench.panel import sub_seed

FORBIDDEN = ("jax", "jaxlib", "flax", "janusx_tpu")
CHECK_KEY = 5
# a traced run traces this long after its untraced window: the device's
# readings are steady well before it, and reading a longer trace takes minutes
TRACE_SECONDS = 15.0


def process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as fh:
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return max(up - int(fields[19]) / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


_AGE0, _T0 = process_age(), time.perf_counter()


def since_process_start() -> float:
    return _AGE0 + time.perf_counter() - _T0


@dataclass
class Context:
    cell: str
    config: dict
    traffic: dict
    seed: int
    device: str


@dataclass
class State:
    """What an entry's ``setup`` returns: the benchmark's data and the
    program's objects (dropped before the reference runs)."""

    ctx: Context
    panel: object  # panel.Panel
    traits: object  # traits.TraitStream
    shape: dict  # m, n, T, ...: the step's sizes, for the metric readers
    program: dict


@dataclass
class Step:
    t0: float
    t1: float
    first: int  # index of its first trait
    traits: int
    tests: int  # SNP x trait tests it completed (0 if it failed)


@dataclass
class RunRecord:
    """What a metric reader sees."""

    cell: str
    config: dict
    traffic: dict
    shape: dict  # m, n, T, G, p: the step's sizes, from the entry
    steps: list
    window_s: float
    setup_s: float
    spans: dict = field(default_factory=dict)  # name -> [seconds per call]
    trace: object = None  # trace.TraceData of a traced run
    traced: list = field(default_factory=list)  # the steps the trace covers

    def tests_per_s(self) -> float | None:
        """SNP x trait tests completed in the window / the window."""
        tests = sum(s.tests for s in self.steps)
        return tests / self.window_s if self.window_s > 0 and tests else None

    def idle_pct(self) -> float | None:
        """100 x (1 - the device's busy time / the traced window)."""
        tr = self.trace
        if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
            return None
        return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def process_cpu_s() -> float:
    """CPU seconds this process has used, its threads summed."""
    return sum(os.times()[:2])


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_info() -> dict:
    """Name, power limit and clocks as nvidia-smi reads them."""
    q = "name,power.limit,clocks.sm,clocks.max.sm"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return {}
    line = out.strip().splitlines()[0] if out.strip() else ""
    return dict(zip(q.split(","), (x.strip() for x in line.split(",")))) if line else {}


def span(name: str):
    """A ``record_function`` span that the trace reads as portbench.<name>."""
    from torch.profiler import record_function

    return record_function(f"portbench.{name}")


def release(state) -> None:
    """Drop the program's objects (an entry keeps them in ``state.program``),
    and with them its device caches, before the reference runs."""
    import gc

    import torch

    state.program.clear()
    gc.collect()
    if state.ctx.device == "cuda":
        torch.cuda.empty_cache()


def check_sample(seed: int, finished: list, k: int) -> list:
    """k of the finished traits, drawn from the seed."""
    rng = np.random.default_rng(sub_seed(seed, CHECK_KEY))
    k = min(k, len(finished))
    return sorted(int(i) for i in rng.choice(finished, k, replace=False)) if k else []


def window(ent, state, T: int, seconds: float, first: int, spans: dict, outputs: dict,
           err) -> tuple[list, float]:
    """Steps back to back from trait ``first`` until ``seconds`` have passed;
    each step's traits land in ``outputs``. Returns the steps and the
    window's length, which ends when its last step ends."""
    steps: list[Step] = []
    t_start = time.perf_counter()
    deadline = t_start + seconds
    i = first
    while time.perf_counter() < deadline:
        with span("traffic"):
            Y = state.traits.batch(i, T)
        t0 = time.perf_counter()
        try:
            with span("step"):
                outs = ent.step(state, Y, spans)
            t1 = time.perf_counter()
            outputs.update({i + t: o for t, o in enumerate(outs)})
            steps.append(Step(t0, t1, i, T, state.shape["m"] * T))
        except Exception:  # a failed step counts as T failed traits
            t1 = time.perf_counter()
            traceback.print_exc(file=err)
            steps.append(Step(t0, t1, i, T, 0))
        i += T
    window_s = steps[-1].t1 - t_start if steps else 0.0
    if steps:
        q = np.percentile([s.t1 - s.t0 for s in steps], [0, 25, 50, 75, 100])
        print(f"portbench: {len(steps)} steps in {window_s:.3f} s; step s min/q1/median/q3/max "
              + " ".join(f"{x:.4f}" for x in q), file=err)
    return steps, window_s


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             manifest: mf.Manifest | None = None, device: str = "cuda",
             out=sys.stdout, err=sys.stderr) -> int:
    """One run; prints the result line to ``out``. Returns the exit code."""
    import torch

    man = manifest or mf.Manifest()
    w = man.cell(cell)
    tr = man.traffic(w["traffic"])
    ctx = Context(cell=cell, config=man.config(w["config"]), traffic=tr, seed=seed,
                  device=device)
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < w["chips"]:
            print(f"portbench: {cell} needs {w['chips']} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=err)
            return 2
    card = card_info() if device == "cuda" else {}
    if card:
        print(f"portbench: card {card}", file=err)
    ent = mf.entry(tr["entry"])
    state = ent.setup(ctx)
    T = tr["traits_per_step"]
    outputs: dict = {}
    setup_s = since_process_start()
    print(f"portbench: setup_s {setup_s!r}", file=err)
    spans: dict = {}
    c0 = process_cpu_s()
    steps, window_s = window(ent, state, T, seconds, 0, spans, outputs, err)
    # CPU seconds over the window; more than the window: threads ran beside the step
    host = {"process_cpu_s": process_cpu_s() - c0}
    tdata, traced = None, []
    if trace:
        # the host-clock readers take the untraced window above; the device
        # readers a traced stretch after it, of the same steps
        from portbench.trace import Profiler

        prof = Profiler().__enter__()
        traced, _ = window(ent, state, T, TRACE_SECONDS, len(steps) * T, {}, outputs, err)
        t = time.perf_counter()
        prof.__exit__(None, None, None)
        t_stop = time.perf_counter()
        tdata = prof.data()
        print(f"portbench: trace stop {t_stop - t:.2f} s, read {time.perf_counter() - t_stop:.2f} s,"
              f" {len(tdata.dev_names)} device ops, {len(tdata.host_names)} host events", file=err)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    rec = RunRecord(cell=cell, config=ctx.config, traffic=tr, shape=state.shape,
                    steps=steps, window_s=window_s, setup_s=setup_s, spans=spans,
                    trace=tdata, traced=traced)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in man.metrics(cell, kind):
        v = mf.reader(m["name"], man.base)(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    attempted = sum(s.traits for s in steps + traced)
    failed = sum(s.traits for s in steps + traced if s.tests == 0)
    finished = sorted(outputs)
    sample = check_sample(seed, finished, tr["check"]["traits"])
    release(state)
    t = time.perf_counter()
    numbers = (compare.gaps([outputs[k] for k in sample], ent.reference(state, sample))
               if sample else {})
    print(f"portbench: check {time.perf_counter() - t:.2f} s", file=err)
    limits = man.limits(cell)
    # the numbers the cell's limits name; one that is not finite (NaN, a
    # missing answer) or was not produced reads as 1e300
    value = lambda v: float(v) if v is not None and np.isfinite(v) else 1e300
    checks = {k: {"value": value(numbers.get(k)), "limit": lim} for k, lim in limits.items()}
    correct = (failed == 0 and bool(sample) and bool(limits)
               and all(c["value"] <= c["limit"] for c in checks.values()))
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}; the run may not import JAX or janusx_tpu", file=err)
        return 3
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": w["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if tdata is not None:
        t = time.perf_counter()
        dev["busy_s"] = tdata.busy_s
        dev["window_s"] = tdata.window_s
        result["breakdown"] = {"device_ops": tdata.top_ops(), "idle_gaps": tdata.idle_gaps()}
        print(f"portbench: breakdown {time.perf_counter() - t:.2f} s", file=err)
    result["host"] = host
    result["card"] = card
    result["checked_traits"] = sample
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=err)
    err.flush()
    print(json.dumps(result), file=out)
    out.flush()
    return 0
