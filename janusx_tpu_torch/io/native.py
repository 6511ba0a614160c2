"""ctypes bindings for the native host IO kernels (native/jxio.cpp).

The shared library is built on demand with g++ (cached next to the
source); every caller must handle ``available() == False`` and fall back
to the pure-Python path, so environments without a toolchain still work.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("janusx_tpu.native")

from janusx_tpu_torch.utils.nativelib import locate as _locate_native

_SRC, _SO = _locate_native("jxio")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-march=native", "-shared", "-fPIC", _SRC, "-o", _SO],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception as e:  # no toolchain / build failure -> fallback
        log.debug("native build failed: %s", e)
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        # rebuild when the source is present and newer; a packaged layout
        # shipping only the .so is usable without the source tree
        have_src = os.path.exists(_SRC)
        if not os.path.exists(_SO) or (
            have_src and os.path.getmtime(_SO) < os.path.getmtime(_SRC)
        ):
            if (not have_src or not _build()) and not os.path.exists(_SO):
                return None  # a stale-but-present .so (e.g. a read-only
                # wheel install without a toolchain) still loads below
        try:
            lib = ctypes.CDLL(_SO)
            lib.jx_vcf_parse_block.restype = ctypes.c_long
            lib.jx_vcf_parse_block.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_long, ctypes.c_long,
                ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ]
            lib.jx_count_lines.restype = ctypes.c_long
            lib.jx_count_lines.argtypes = [ctypes.c_char_p, ctypes.c_long]
            _lib = lib
        except (OSError, AttributeError) as e:
            log.debug("native load failed: %s", e)
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def parse_vcf_block(data: bytes, n_samples: int, n_lines_hint: int):
    """Parse newline-separated VCF data lines.

    Returns (packed (m, nb) uint8 dosage codes, meta list of 5-tuples of
    bytes) or None when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    nb = (n_samples + 3) // 4
    max_lines = max(n_lines_hint, 1)
    packed = np.empty((max_lines, nb), dtype=np.uint8)
    off = np.empty((max_lines, 5), dtype=np.int64)
    length = np.empty((max_lines, 5), dtype=np.int64)
    m = lib.jx_vcf_parse_block(
        data,
        len(data),
        n_samples,
        max_lines,
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        nb,
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        length.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
    )
    if m < 0:
        bad = -int(m) - 1
        lines = data.split(b"\n")
        snippet = lines[bad][:120].decode(errors="replace") if bad < len(lines) else ""
        raise ValueError(
            f"malformed VCF data line {bad} (truncated or non-VCF content): "
            f"{snippet!r}"
        )
    meta = []
    for i in range(m):
        meta.append(
            tuple(
                data[off[i, f] : off[i, f] + length[i, f]].decode()
                for f in range(5)
            )
        )
    return packed[:m], meta
