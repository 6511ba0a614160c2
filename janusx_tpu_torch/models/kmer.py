"""K-mer counting and k-mer presence/absence genotype matrices.

Replaces the reference's KMC-based k-mer pipeline
(JanusX src/kmer/ + vendored KMC: count per sample, merge to a
0/1 presence matrix usable as a genotype input for GWAS/GS). The counter
is our own compact C++ hash kernel (native/jxkmer.cpp, ctypes-loaded).
"""

from __future__ import annotations

import ctypes
import gzip
import os
import subprocess
import threading

import numpy as np

from janusx_tpu_torch.utils.nativelib import locate as _locate_native

_SRC, _SO = _locate_native("jxkmer")
_lock = threading.Lock()
_lib = None
_tried = False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        # rebuild when the source is present and newer; a packaged layout
        # shipping only the .so must not crash on the missing source tree
        have_src = os.path.exists(_SRC)
        stale = (
            not os.path.exists(_SO)
            or (have_src and os.path.getmtime(_SO) < os.path.getmtime(_SRC))
        )
        if stale:
            built = False
            if have_src:
                try:
                    subprocess.run(
                        ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                         "-pthread", _SRC, "-o", _SO],
                        check=True, capture_output=True, timeout=120,
                    )
                    built = True
                except Exception:
                    pass
            if not built and not os.path.exists(_SO):
                return None  # stale-but-present .so still loads below
        try:
            lib = ctypes.CDLL(_SO)
            lib.jx_kmt_new.restype = ctypes.c_void_p
            lib.jx_kmt_new.argtypes = [ctypes.c_int, ctypes.c_int]
            lib.jx_kmt_new2.restype = ctypes.c_void_p
            lib.jx_kmt_new2.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_long, ctypes.c_char_p,
            ]
            lib.jx_kmt_spilling.restype = ctypes.c_int
            lib.jx_kmt_spilling.argtypes = [ctypes.c_void_p]
            lib.jx_kmt_part_load.restype = ctypes.c_long
            lib.jx_kmt_part_load.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.jx_kmt_part_size.restype = ctypes.c_long
            lib.jx_kmt_part_size.argtypes = [ctypes.c_void_p, ctypes.c_int]
            lib.jx_kmt_spill_finalize.restype = ctypes.c_long
            lib.jx_kmt_spill_finalize.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_uint32]
            lib.jx_kmt_spill_collect.restype = ctypes.c_long
            lib.jx_kmt_spill_collect.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32), ctypes.c_long]
            lib.jx_kmt_part_export.restype = ctypes.c_long
            lib.jx_kmt_part_export.argtypes = [
                ctypes.c_void_p, ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_long, ctypes.c_uint32,
            ]
            lib.jx_kmt_add.restype = ctypes.c_int
            lib.jx_kmt_add.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_long]
            lib.jx_kmt_size.restype = ctypes.c_long
            lib.jx_kmt_size.argtypes = [ctypes.c_void_p]
            lib.jx_kmt_export.restype = ctypes.c_long
            lib.jx_kmt_export.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_uint64),
                ctypes.POINTER(ctypes.c_uint32),
                ctypes.c_long,
                ctypes.c_uint32,
            ]
            lib.jx_kmt_free.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, AttributeError):
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


# two-word (k > 32) k-mer codes cross the ABI as (lo, hi) u64 pairs and
# live in Python as this structured dtype (field order hi-first so numpy
# comparisons/sorts order them numerically)
WIDE_DTYPE = np.dtype([("hi", "<u8"), ("lo", "<u8")])


def _wide_view(pairs: np.ndarray) -> np.ndarray:
    """(w, 2) interleaved (lo, hi) export buffer -> sorted-comparable
    structured codes."""
    out = np.empty(pairs.shape[0], WIDE_DTYPE)
    out["lo"] = pairs[:, 0]
    out["hi"] = pairs[:, 1]
    return out


def _open_seq(path: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rb")
    return open(path, "rb")


def _last_record_start(chunk: bytes, fastq: bool) -> int:
    """Offset of the last record header in ``chunk`` (0 if none found).

    FASTA: last '\\n>'. FASTQ: walk '\\n@' candidates backward and accept
    the first whose line+2 starts with '+' (quality lines that begin with
    '@' fail that check — mirrors the native splitter)."""
    if not fastq:
        i = chunk.rfind(b"\n>")
        return i + 1 if i >= 0 else 0
    pos = len(chunk)
    while True:
        i = chunk.rfind(b"\n@", 0, pos)
        if i < 0:
            return 0
        l1 = chunk.find(b"\n", i + 1)
        l2 = chunk.find(b"\n", l1 + 1) if l1 >= 0 else -1
        if l2 >= 0 and l2 + 1 < len(chunk) and chunk[l2 + 1:l2 + 2] == b"+":
            return i + 1
        pos = i


_BASES = frozenset(b"ACGTacgt")


def _tail_base_cut(buf: bytes, nbases: int) -> int:
    """Offset such that buf[cut:] holds the last ``nbases`` base chars
    (plus any interleaved newlines). Returns 0 if fewer bases exist."""
    seen = 0
    for i in range(len(buf) - 1, -1, -1):
        if buf[i] in _BASES:
            seen += 1
            if seen >= nbases:
                return i
    return 0


def count_kmers(
    path: str, k: int = 21, min_count: int = 1, threads: int | None = None,
    chunk_bytes: int = 256 << 20,
    mem_budget_bytes: int | None = None,
    spill_dir: str | None = None,
):
    """Count canonical k-mers of one FASTA/FASTQ(.gz) file.

    Streams the file in record-aligned chunks through the multithreaded
    native counter — host memory is bounded by the k-mer table plus one
    chunk, not the (decompressed) file.

    ``mem_budget_bytes`` bounds the in-RAM tables (KMC-lite capability,
    reference vendored KMC3): when the next chunk could cross the budget
    the counter converts to on-disk partition buckets under ``spill_dir``
    (a temp dir by default) and finalizes buckets in parallel (~1/256 of the
    distinct set) at a time — all-distinct inputs larger than RAM
    complete instead of swapping. With ``spill_dir=""`` the counter
    instead FAILS FAST with a clear error at 2x the budget.

    Returns (codes uint64 sorted, counts uint32)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native k-mer counter unavailable (no g++?)")
    tmp_ctx = None
    if mem_budget_bytes:
        if spill_dir is None:
            import tempfile

            tmp_ctx = tempfile.TemporaryDirectory(prefix="jxkmer_spill_")
            spill_dir = tmp_ctx.name
        elif spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        # bound the per-chunk worst-case distinct load (18 B/code) to
        # half the budget so the native pre-check has room to convert;
        # once spilling starts, chunks append straight to the on-disk
        # buckets (tables no longer grow) and the full chunk size returns
        full_chunk = chunk_bytes
        chunk_bytes = max(1 << 20, min(chunk_bytes, mem_budget_bytes // 36))
        h = lib.jx_kmt_new2(
            k, 0 if threads is None else threads, int(mem_budget_bytes),
            spill_dir.encode(),
        )
    else:
        h = lib.jx_kmt_new(k, 0 if threads is None else threads)
    if not h:
        raise RuntimeError(f"bad k for k-mer counting: {k}")
    try:
        _feed_path(lib, h, path, k, chunk_bytes,
                   mem_budget_bytes,
                   full_chunk if mem_budget_bytes else chunk_bytes)
        wide = k > 32

        def _alloc(n):
            return np.empty((n, 2) if wide else n, np.uint64)

        def _finish(keys, cnts, w):
            cnts = cnts[:w]
            codes = _wide_view(keys[:w]) if wide else keys[:w]
            return codes, cnts

        if mem_budget_bytes and lib.jx_kmt_spilling(h):
            # spilled finalize: T workers count buckets in parallel (<= T
            # partition tables in flight — bounded memory) and park the
            # sorted, filtered results; partitions are key ranges, so the
            # one collect pass below is globally key-sorted already
            total = lib.jx_kmt_spill_finalize(h, min_count)
            if total < 0:
                raise RuntimeError("k-mer spill bucket unreadable")
            keys = _alloc(total)
            cnts = np.empty(total, np.uint32)
            w = lib.jx_kmt_spill_collect(
                h,
                keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                total,
            )
            return _finish(keys, cnts, w)
        n = lib.jx_kmt_size(h)
        keys = _alloc(n)
        cnts = np.empty(n, np.uint32)
        # the native export is key-range partitioned + per-partition
        # sorted -> arrives globally sorted (no host argsort)
        w = lib.jx_kmt_export(
            h,
            keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            cnts.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            n,
            min_count,
        )
        keys, cnts = _finish(keys, cnts, w)
    finally:
        lib.jx_kmt_free(h)
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    return keys, cnts


def _feed_path(lib, h, path: str, k: int, chunk_bytes: int,
               mem_budget_bytes, full_chunk: int) -> None:
    """Stream one FASTA/FASTQ(.gz) file into a counter handle in
    record-aligned chunks (shared by count_kmers and stream_kmer_count)."""
    carry = b""
    fastq = None
    with _open_seq(path) as fh:
        while True:
            data = fh.read(chunk_bytes)
            if not data:
                break
            buf = carry + data if carry else data
            if fastq is None:
                fastq = buf[:1] == b"@"
            if len(data) == chunk_bytes:  # maybe more coming: hold the tail record
                cut = _last_record_start(buf, fastq)
                if cut == 0 and not fastq and len(buf) > chunk_bytes:
                    # single FASTA record larger than the chunk: feed
                    # the WHOLE partial body now (the parser's
                    # bare-sequence branch continues it next round)
                    # and carry only the last k-1 bases — exactly the
                    # context boundary-spanning k-mers need, while a
                    # k-1 stretch alone cannot re-form a full window
                    # (no double counting). Memory stays bounded by
                    # the chunk, not the record.
                    feed, carry = buf, buf[_tail_base_cut(buf, k - 1):]
                else:
                    feed, carry = buf[:cut], buf[cut:]
            else:
                feed, carry = buf, b""
            if feed:
                _check_add(lib, h, feed, mem_budget_bytes)
                if (mem_budget_bytes and chunk_bytes < full_chunk
                        and lib.jx_kmt_spilling(h)):
                    # buckets absorb appends, but phase-1 staging still
                    # holds ~one code per base of the chunk (8 B, 16 B
                    # for k > 32) — cap the restored chunk so staging
                    # stays inside the budget
                    per_base = 17 if k > 32 else 9
                    chunk_bytes = max(
                        1 << 20,
                        min(full_chunk, mem_budget_bytes // per_base))
    if carry:
        _check_add(lib, h, carry, mem_budget_bytes)


DB_MAGIC = b"JXKMERDB"


def stream_kmer_count(
    path: str, out_path: str, k: int = 21, min_count: int = 1,
    threads: int | None = None, chunk_bytes: int = 256 << 20,
    mem_budget_bytes: int | None = None, spill_dir: str | None = None,
) -> int:
    """Count canonical k-mers and STREAM the sorted table to disk.

    The all-distinct adversarial case of ``count_kmers`` is RAM-bound by
    its own return value (the full (codes, counts) table — 4.8 GB at
    400M distinct 21-mers); KMC streams its output instead. This is the
    equivalent streamed mode: partitions are exported one at a time in
    key order and appended to ``out_path``, so peak host memory is ~1/256
    of the table (RAM mode) or one bucket (spill mode). Returns the
    number of records written.

    Format (`load_kmer_db` reads it): 16-byte header (b"JXKMERDB",
    version u8=1, k u8, wide u8, 5 zero pad), then key-sorted records —
    (code u64, count u32) narrow, (lo u64, hi u64, count u32) wide.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native k-mer counter unavailable (no g++?)")
    tmp_ctx = None
    full_chunk = chunk_bytes
    if mem_budget_bytes:
        if spill_dir is None:
            import tempfile

            tmp_ctx = tempfile.TemporaryDirectory(prefix="jxkmer_spill_")
            spill_dir = tmp_ctx.name
        elif spill_dir:
            os.makedirs(spill_dir, exist_ok=True)
        chunk_bytes = max(1 << 20, min(chunk_bytes, mem_budget_bytes // 36))
        h = lib.jx_kmt_new2(
            k, 0 if threads is None else threads, int(mem_budget_bytes),
            spill_dir.encode(),
        )
    else:
        h = lib.jx_kmt_new(k, 0 if threads is None else threads)
    if not h:
        raise RuntimeError(f"bad k for k-mer counting: {k}")
    wide = k > 32
    rec_words = 2 if wide else 1
    written = 0
    try:
        _feed_path(lib, h, path, k, chunk_bytes, mem_budget_bytes,
                   full_chunk)
        spilled = bool(mem_budget_bytes) and bool(lib.jx_kmt_spilling(h))
        with open(out_path, "wb") as fh:
            fh.write(DB_MAGIC + bytes([1, k, 1 if wide else 0]) + b"\0" * 5)
            kp = ctypes.POINTER(ctypes.c_uint64)
            cp = ctypes.POINTER(ctypes.c_uint32)
            for p in range(256):
                if spilled:
                    n = lib.jx_kmt_part_load(h, p)
                    if n < 0:
                        raise RuntimeError("k-mer spill bucket unreadable")
                else:
                    n = lib.jx_kmt_part_size(h, p)
                if n <= 0:
                    continue
                keys = np.empty(n * rec_words, np.uint64)
                cnts = np.empty(n, np.uint32)
                w = lib.jx_kmt_part_export(
                    h, p, keys.ctypes.data_as(kp), cnts.ctypes.data_as(cp),
                    n, min_count)
                if w <= 0:
                    continue
                rec = np.zeros(
                    w, dtype=_db_dtype(wide))
                if wide:
                    kv = keys[: 2 * w].reshape(w, 2)
                    rec["lo"], rec["hi"] = kv[:, 0], kv[:, 1]
                else:
                    rec["code"] = keys[:w]
                rec["count"] = cnts[:w]
                rec.tofile(fh)
                written += int(w)
    finally:
        lib.jx_kmt_free(h)
        if tmp_ctx is not None:
            tmp_ctx.cleanup()
    return written


def _db_dtype(wide: bool):
    if wide:
        return np.dtype([("lo", "<u8"), ("hi", "<u8"), ("count", "<u4")])
    return np.dtype([("code", "<u8"), ("count", "<u4")])


def load_kmer_db(path: str, mmap: bool = True):
    """Read a streamed .jxkdb table -> (codes, counts, k).

    With ``mmap`` the records stay on disk (np.memmap) and the returned
    arrays are views — iterating a 4.8 GB table costs pages, not RAM.
    Narrow codes return as u64 views; wide (k > 32) codes are COPIED
    into the package-wide WIDE_DTYPE ("hi","lo") layout so they are
    dtype-identical to count_kmers' wide output (concatenable/sortable
    alongside .npz-loaded tables) — wide tables therefore materialize
    16 B/record on load."""
    with open(path, "rb") as fh:
        head = fh.read(16)
    if len(head) < 16 or head[:8] != DB_MAGIC:
        raise ValueError(f"{path}: not a jxkdb k-mer table")
    if head[8] != 1:
        raise ValueError(
            f"{path}: unsupported jxkdb version {head[8]} (expected 1)")
    k, wide = head[9], bool(head[10])
    dt = _db_dtype(wide)
    rec = (np.memmap(path, dtype=dt, mode="r", offset=16) if mmap
           else np.fromfile(path, dtype=dt, offset=16))
    if wide:
        codes = np.empty(len(rec), WIDE_DTYPE)
        codes["lo"] = rec["lo"]
        codes["hi"] = rec["hi"]
    else:
        codes = rec["code"]
    return codes, rec["count"], int(k)


def _check_add(lib, h, feed: bytes, mem_budget_bytes) -> None:
    rc = lib.jx_kmt_add(h, feed, len(feed))
    if rc == 2:
        raise MemoryError(
            f"k-mer table crossed 2x the memory budget "
            f"({mem_budget_bytes} bytes) and no spill directory is "
            f"configured — rerun with a larger budget, or allow spilling "
            f"(spill_dir=None uses a temp dir)"
        )
    if rc != 0:
        raise RuntimeError("k-mer counting failed")


def decode_kmer(code, k: int) -> str:
    """2-bit code -> ACGT string; accepts plain ints (k <= 32) and the
    two-word structured codes (k > 32)."""
    names = getattr(getattr(code, "dtype", None), "names", None)
    if names == ("hi", "lo"):
        code = (int(code["hi"]) << 64) | int(code["lo"])
    return "".join("ACGT"[(int(code) >> (2 * (k - 1 - i))) & 3] for i in range(k))


def merge_to_matrix(per_sample: dict, min_samples: int = 2, max_samples=None):
    """Merge per-sample k-mer sets into a presence/absence matrix.

    per_sample: {sample_id: (codes, counts)}. Keeps k-mers present in
    [min_samples, max_samples] samples (segregating). Returns
    (codes (m,), matrix (m, n) int8, sample_ids)."""
    samples = list(per_sample.keys())
    n = len(samples)
    max_samples = n - 1 if max_samples is None else max_samples
    all_codes = np.unique(np.concatenate([per_sample[s][0] for s in samples]))
    mat = np.zeros((len(all_codes), n), np.int8)
    for j, s in enumerate(samples):
        codes = per_sample[s][0]
        idx = np.searchsorted(all_codes, codes)
        mat[idx, j] = 1
    presence = mat.sum(axis=1)
    keep = (presence >= min_samples) & (presence <= max_samples)
    return all_codes[keep], mat[keep], np.array(samples, dtype=object)


def kmer_matrix_to_genotypes(codes: np.ndarray, mat: np.ndarray, samples, k: int):
    """Wrap a presence matrix as GenotypeData (dosage 0/1) for GWAS/GS."""
    from janusx_tpu_torch.io.gdata import GenotypeData, SiteInfo

    m = len(codes)
    sites = SiteInfo(
        chrom=np.array(["K"] * m, object),
        pos=np.arange(1, m + 1, dtype=np.int64),
        snp=np.array([decode_kmer(c, k) for c in codes], object),
        allele0=np.array(["absent"] * m, object),
        allele1=np.array(["present"] * m, object),
    )
    return GenotypeData(mat.astype(np.int8), sites, samples)
