"""Association result TSV writer (async, background thread).

Schemas and formatting mirror the reference
(JanusX src/io/assoc2tsv.rs:45-57 headers; :384-540 row formats;
chisq = (beta/se)^2 formatted %.4e or NaN, src/math/linalg.rs:289-310):

  basic  (11): chrom pos snp allele0 allele1 af miss beta se chisq pwald
  plrt   (12): ... + plrt
  lmm2   (14): ... + lambda ml plrt           (lambda/ml at %.6e)

af/miss/beta/se print at 4 decimal places; p-values at %.4e. (Python's
exponent always has >=2 digits where Rust may print one — numerically
identical.) Rows stream to a background thread so device compute never
waits on disk.
"""

from __future__ import annotations

import math
import queue
import threading

import numpy as np

HEADER_BASIC = "chrom\tpos\tsnp\tallele0\tallele1\taf\tmiss\tbeta\tse\tchisq\tpwald"
HEADER_PLRT = HEADER_BASIC + "\tplrt"
HEADER_LMM2 = HEADER_BASIC + "\tlambda\tml\tplrt"


def _fmt_chisq(v: float) -> str:
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "inf" if v > 0 else "-inf"
    return f"{v:.4e}"


def format_assoc_rows(
    sites,
    af: np.ndarray,
    miss: np.ndarray,
    beta: np.ndarray,
    se: np.ndarray,
    pwald: np.ndarray,
    plrt: np.ndarray | None = None,
    lmm2: tuple[np.ndarray, np.ndarray] | None = None,  # (lambda, ml)
    extras: list | None = None,  # [(name, array)] appended columns
) -> str:
    """Format a block of rows to TSV text (no header)."""
    out = []
    chrom, pos, snp = sites.chrom, sites.pos, sites.snp
    a0, a1 = sites.allele0, sites.allele1
    n = len(af)
    for i in range(n):
        b, s = float(beta[i]), float(se[i])
        chisq = (b / s) ** 2 if (math.isfinite(b) and math.isfinite(s) and s > 0) else float("nan")
        base = (
            f"{chrom[i]}\t{pos[i]}\t{snp[i]}\t{a0[i]}\t{a1[i]}"
            f"\t{af[i]:.4f}\t{miss[i]:.4f}\t{b:.4f}\t{s:.4f}"
            f"\t{_fmt_chisq(chisq)}\t{pwald[i]:.4e}"
        )
        if lmm2 is not None:
            lbd, ml = lmm2
            base += f"\t{lbd[i]:.6e}\t{ml[i]:.6e}\t{plrt[i]:.4e}"
        elif plrt is not None:
            base += f"\t{plrt[i]:.4e}"
        if extras:
            for name, arr in extras:
                v = float(arr[i])
                if name.startswith(("beta", "se")):
                    base += f"\t{v:.4f}"
                elif name.startswith("chisq"):
                    base += f"\t{_fmt_chisq(v)}"
                else:
                    base += f"\t{v:.4e}"
        out.append(base)
    return "\n".join(out) + "\n"


class AsyncTsvWriter:
    """Background-thread TSV writer (reference AsyncTsvWriter,
    src/stats/common.rs:374-399)."""

    def __init__(self, path: str, header: str, queue_depth: int = 16):
        self.path = path
        self._q: queue.Queue[str | None] = queue.Queue(maxsize=queue_depth)
        self._exc: BaseException | None = None
        self._fh = open(path, "wt", buffering=1024 * 1024)
        self._fh.write(header + "\n")
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    def _run(self):
        try:
            while True:
                chunk = self._q.get()
                if chunk is None:
                    break
                self._fh.write(chunk)
        except BaseException as e:  # surfaced on the next write()/close()
            self._exc = e
            # keep draining so producers blocked on a full queue wake up
            # instead of deadlocking against a dead consumer
            while True:
                chunk = self._q.get()
                if chunk is None:
                    break

    def _put(self, item: str | None):
        # poll so a consumer that died between the _exc check and the put
        # still surfaces its error instead of blocking forever
        while True:
            if self._exc:
                raise self._exc
            try:
                self._q.put(item, timeout=0.5)
                return
            except queue.Full:
                continue

    def write(self, text: str):
        self._put(text)

    def close(self):
        try:
            self._put(None)
        finally:
            if self._exc:
                try:  # unblock the consumer's drain loop
                    self._q.put_nowait(None)
                except queue.Full:
                    pass
            self._t.join(timeout=10.0)
            try:
                self._fh.close()
            except Exception:
                pass
        if self._exc:
            raise self._exc

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
