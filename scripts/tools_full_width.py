"""Time the port's genotype tools at the full width of chip_smoke.py's
panel (1,940 samples x 600,000 SNPs), where the smoke's phase 16 runs them
on one chromosome or on part of one.

    python scripts/tools_full_width.py [--panel PREFIX]

Without ``--panel`` it writes the smoke's phase 5 panel into a temporary
directory first (chip_smoke.write_panel, ~1-2 min on the host). On the
card (JX_TPU_PLATFORM=cuda), through the port's CLI, it then times:
``jx gformat -prune 50 5 0.2`` over the whole panel (the r² chunks, which
run on the card, apart from the rest: load, QC, the host's greedy window
walk, the .bed write); ``jx gformat -chr 1`` to ``-fmt vcf`` and ``-fmt
hmp`` and the port's reader on each output; and ``jx hybrid`` build mode
on 20 x 20 parents of the whole panel. It prints the card's name and power
limit, one line per command, and last one JSON line of every number.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--panel", default=None, help="PLINK prefix of chip_smoke's panel")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from janusx_tpu_torch import config

    if not torch.cuda.is_available():
        raise SystemExit("needs one NVIDIA GPU")
    os.environ["JX_TPU_PLATFORM"] = "cuda"
    os.environ["JX_TPU_HISTORY_DB"] = "0"
    config.set_full_f32_matmul()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    res = {"card": smi}
    with tempfile.TemporaryDirectory(prefix="jx_tools_") as d:
        prefix = args.panel
        if prefix is None:
            t0 = time.monotonic()
            prefix = cs.write_panel(d, cs.M_SNPS)[0]
            res["panel_write_s"] = time.monotonic() - t0
        out = os.path.join(d, "tools")

        from janusx_tpu_torch.io import gfreader, plink
        from janusx_tpu_torch.models import ldprune

        targets = {"load": (gfreader, "load_raw_packed"), "qc": (gfreader.RawPacked, "prepare"),
                   "ld_prune": (ldprune, "ld_prune"),
                   "write": (plink, "write_plink_genotypes")}
        with cs.probe(targets) as rec, cs.r2_probe(int(cs.PRUNE[0])) as r2:
            printed, wall, _ = cs.run_cli(["gformat", "-bfile", prefix, "-prune", *cs.PRUNE,
                                           "-o", out, "-prefix", "pruned"], "prune")
        walk = rec["ld_prune"]["s"] - r2["s"]
        res["prune"] = {"cli_s": wall, "stages_s": {k: r["s"] for k, r in rec.items()},
                        "r2_chunks": r2["calls"], "r2_s": r2["s"], "host_walk_s": walk,
                        "printed": printed}
        print(f"gformat -prune {' '.join(cs.PRUNE)} on {cs.M_SNPS} SNPs: {cs.stages(rec)}; "
              f"of ld_prune, {r2['calls']} r² chunks on the card {r2['s']:.3f} s and the host "
              f"walk {walk:.3f} s; cli {wall:.2f} s ({smi})", flush=True)

        from janusx_tpu_torch.io.gfreader import load_raw_packed

        res["convert"] = {}
        for fmt, path in (("vcf", "c1.vcf.gz"), ("hmp", "c1.hmp.txt")):
            _, wall, _ = cs.run_cli(["gformat", "-bfile", prefix, "-chr", cs.TOOLS_CHROM,
                                     "-fmt", fmt, "-o", out, "-prefix", "c1"], f"chr1 {fmt}")
            t0 = time.monotonic()
            raw = load_raw_packed(os.path.join(out, path))
            read_s = time.monotonic() - t0
            res["convert"][fmt] = {"cli_s": wall, "read_s": read_s, "snps": raw.m}
            print(f"gformat -chr {cs.TOOLS_CHROM} -fmt {fmt}: {raw.m} SNPs, cli {wall:.2f} s, "
                  f"read back {read_s:.2f} s", flush=True)

        lists = []
        for k in range(2):
            lists.append(os.path.join(d, f"p{k + 1}.txt"))
            with open(lists[-1], "wt") as fh:
                fh.writelines(f"ind{j}\n" for j in range(k * cs.HYBRID_PARENTS,
                                                         (k + 1) * cs.HYBRID_PARENTS))
        _, wall, _ = cs.run_cli(["hybrid", "-bfile", prefix, "-p1", lists[0], "-p2", lists[1],
                                 "-fmt", "plink", "-o", out, "-prefix", "hb"], "hybrid build")
        res["hybrid_build_s"] = wall
        print(f"hybrid build {cs.HYBRID_PARENTS} x {cs.HYBRID_PARENTS} on {cs.M_SNPS} SNPs: "
              f"cli {wall:.2f} s", flush=True)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
