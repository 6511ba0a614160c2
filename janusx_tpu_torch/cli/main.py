"""`jx` dispatcher of the port: ``python -m janusx_tpu_torch.cli.main
<module> ...``. Only the modules ported so far are listed."""

from __future__ import annotations

import importlib
import sys

from janusx_tpu_torch import __version__

_MODULES: dict[str, tuple[str, str]] = {
    "gwas": ("janusx_tpu_torch.cli.gwas", "GWAS scans (ported: -lmm)"),
}


def _help() -> str:
    lines = [f"janusx_tpu_torch {__version__} — PyTorch/CUDA port of janusx-tpu",
             "", "usage: jx <module> [options]", "", "modules:"]
    lines += [f"  {name:<10} {desc}" for name, (_, desc) in _MODULES.items()]
    return "\n".join(lines)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(_help())
        return 0
    if argv[0] in ("-V", "--version", "version"):
        print(__version__)
        return 0
    entry = _MODULES.get(argv[0])
    if entry is None:
        print(f"module {argv[0]} is not ported to janusx_tpu_torch yet\n\n{_help()}",
              file=sys.stderr)
        return 2
    return int(importlib.import_module(entry[0]).main(argv[1:]) or 0)


if __name__ == "__main__":
    raise SystemExit(main())
