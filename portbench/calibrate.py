"""The readings that a cell's limits are set from: per seed, the numbers
``compare.gaps`` gives for the program's timed path and for the control,
both against the plain reference, on the traits a run checks.

    python -m portbench.calibrate --workload <cell> --seeds 11,12,13 [--control-seeds 11,12,13]

Per seed it does the run's set-up, scans the traits a run would check (as
many as the traffic's ``check.traits``) through the timed path, and then:

- ``program``: the timed path as configured;
- ``reference_low``: the plain reference one precision step down
  (``prec="low"``), put in the program's place;
- for an entry with lower-precision paths of its own (its module's
  ``CONTROL_KNOBS``, the environment that switches them on),
  ``program_low``: the timed path with those paths switched on, and the
  null fit's λ, which no program path computes lower, from
  ``reference_low``. That is the cell's control; otherwise
  ``reference_low`` is.

Each seed prints one JSON line; the last line gives, per number, the
largest program reading and the smallest control reading. The benchmark's
own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from portbench import compare
from portbench import manifest as mf
from portbench.harness import Context, release


def restore(saved: dict) -> None:
    """Put the environment back as ``saved`` read it: unset what was unset."""
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def readings(cell: str, seed: int, control: bool, device: str = "cuda",
             man: mf.Manifest | None = None) -> dict:
    man = man or mf.Manifest()
    w = man.cell(cell)
    tr = man.traffic(w["traffic"])
    ent = mf.entry(tr["entry"])
    state = ent.setup(Context(cell=cell, config=man.config(w["config"]), traffic=tr,
                              seed=seed, device=device))
    T, k = tr["traits_per_step"], tr["check"]["traits"]
    sample = list(range(k))

    def scan():
        outs = []
        for i in range(0, k, T):
            outs += ent.step(state, state.traits.batch(i, T), {})
        return outs[:k]

    out = {"seed": seed, "program": None}
    prog = scan()
    ref = ent.reference(state, sample, "ref")
    out["program"] = compare.gaps(prog, ref)
    if control:
        low = ent.reference(state, sample, "low")
        out["reference_low"] = compare.gaps(low, ref)
        knobs = getattr(ent, "CONTROL_KNOBS", None)
        if knobs:
            saved = {k2: os.environ.get(k2) for k2 in knobs}
            os.environ.update(knobs)
            try:
                plow = scan()
            finally:
                restore(saved)
            for o, lo in zip(plow, low):
                o["lam"] = lo["lam"]
            out["program_low"] = compare.gaps(plow, ref)
        out["control"] = "program_low" if knobs else "reference_low"
    release(state)
    return out


def summary(rows: list) -> dict:
    """Per number: the largest program reading, the smallest control reading."""
    names = rows[0]["program"].keys()
    res = {}
    for k in names:
        lower = max(r["program"][k] for r in rows)
        ctl = [r[r["control"]][k] for r in rows if "control" in r]
        res[k] = {"lower": lower, "upper": min(ctl) if ctl else None,
                  "program": [r["program"][k] for r in rows],
                  "control": ctl}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    ctl = {int(s) for s in a.control_seeds.split(",") if s}
    rows = []
    for s in seeds:
        rows.append(readings(a.workload, s, s in ctl))
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"summary": summary(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
