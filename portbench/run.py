"""Run one cell of the benchmark once:

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result (JSON); the numbers compared with the plain reference are the last
lines of standard error. Exits non-zero, with no result, without the CUDA
cards the cell asks for.
"""

from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".portbench_cache"
# a run's host threads: the steps are led by one host thread, and eight
# BLAS/OpenMP threads on the machine's eight cores spun beside it, made
# every step slower and the runs spread twice as wide (PERF.md, PR 15)
THREADS = 4


def pin() -> None:
    """The process on the first ``THREADS`` of its cores, with as many
    BLAS/OpenMP threads; before numpy or torch are imported."""
    cpus = sorted(os.sched_getaffinity(0))[:THREADS]
    os.sched_setaffinity(0, cpus)
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ[var] = str(len(cpus))


def _cache_dirs() -> None:
    """Kernel and compile caches at fixed paths inside the checkout (the
    port builds its CUDA kernels into build/janusx_tpu_torch/ by itself)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "cuda"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    pin()
    _cache_dirs()
    from portbench.harness import run_cell

    return run_cell(a.workload, a.seed, a.seconds, bool(a.trace))


if __name__ == "__main__":
    sys.exit(main())
