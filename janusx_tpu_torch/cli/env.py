"""`jx env` — list the JX_* expert environment knobs and current values
(reference: the ~60-variable JX_* layer documented in doc/JanusXcli.md)."""

from __future__ import annotations

import argparse


def build_parser(prog="jx env") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog=prog, description="Expert env-knob registry"
    )
    p.add_argument("-set-only", "--set-only", action="store_true",
                   help="show only knobs overridden in the environment")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from janusx_tpu_torch import config

    rows = config.knob_table()
    if args.set_only:
        rows = [r for r in rows if r[3]]
    w = max((len(r[0]) for r in rows), default=10)
    print(f"{'variable':<{w}}  {'current':<22}  {'default':<22}  help")
    for name, cur, default, overridden, help_ in rows:
        mark = "*" if overridden else " "
        print(f"{name:<{w}}{mark} {str(cur):<22}  {str(default):<22}  {help_}")
    if not args.set_only:
        print("\n(* = overridden via environment)")
    return 0
