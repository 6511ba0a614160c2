"""Spans and counters of the port, on the profiler's clock.

``span(name)`` marks a stretch of the program as ``jx.<name>``. While a
``torch.profiler`` session records, it is a ``record_function``, so the
span lands in the trace beside the device's operations, on their clock;
the profiler holds the spans and writes them out. Otherwise it is a shared
null context: a ``record_function`` costs ~10 µs even with no profiler
running, a check of the profiler's flag well under 1 µs. Spans nest: the
parent of a span is the span that encloses it.

``count(name, n)`` adds to a table kept since the process started and,
while a profiler session records, to a second table, so that a trace
carries the counts of the steps it covers. The profiled table holds what
every session of the process recorded; a process that traces once reads it
as that trace's. The counts are updated by the thread that issues the
device work.

Names in use: the spans of the scans (``fit_null``, ``rotate_y``,
``null_brent``, ``lmm_scan``, ``feed``, ``superblock``, ``upload``,
``kernels``, ``to_host``, ``results``, ``splmm_grammar_scan``,
``sparse_null``, ``block_spectral``, ``gamma``, ``host_p``, ``lowrank_scan``,
``lr_rotate_y``, ``lr_null``, ``lr_basis``, ``lr_lattice``) and the stages
of ``jx gwas``; the counters ``h2d_bytes`` (bytes copied from the host to a
device), ``launch.<wrapper>`` (ops.kernels' launches), ``gamma.card`` /
``gamma.host`` (GRAMMAR γ calibrations on the device / on the host),
``lowrank.superblocks`` (resident superblocks of the low-rank scan),
``feed.resident`` / ``feed.streamed`` (superblocks served as a slice of a
panel held on the device / uploaded on their own, models.superblocks) and
``null_fit.card`` / ``null_fit.plain`` (dense null REML fits through the
null_reml_brent kernel, one per trait, / through the torch version).
"""

from __future__ import annotations

import contextlib
import functools

import torch.autograd.profiler as _profiler

PREFIX = "jx."
H2D = "h2d_bytes"

_NULL = contextlib.nullcontext()
_counts: dict[str, int] = {}
_profiled: dict[str, int] = {}


def span(name: str):
    """``record_function("jx." + name)`` while a profiler records, else a
    null context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(PREFIX + name)
    return _NULL


def spanned(name: str):
    """A decorator: every call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``name`` (in the profiled table too while a profiler
    records)."""
    _counts[name] = _counts.get(name, 0) + n
    if _profiler._is_profiler_enabled:
        _profiled[name] = _profiled.get(name, 0) + n


def counts(profiled: bool = False) -> dict[str, int]:
    """A copy of the table since process start, or of the profiled one."""
    return dict(_profiled if profiled else _counts)


def reset(prefix: str) -> None:
    """Drop the counters whose names start with ``prefix`` from both tables."""
    for table in (_counts, _profiled):
        for name in [k for k in table if k.startswith(prefix)]:
            del table[name]


def uploaded(t):
    """``t``, a tensor or a list of tensors just copied from the host; the
    bytes of those not on the host are counted under ``h2d_bytes``."""
    for x in (t if isinstance(t, list) else (t,)):
        if x.device.type != "cpu":
            count(H2D, x.nbytes)
    return t
