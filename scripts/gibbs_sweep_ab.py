"""Time the port's two Gibbs-sweep kernels (G1 ``gibbs_sweep_marker``, G2
``gibbs_sweep_block_mvn``, janusx_tpu_torch/csrc/gibbs.cu) of one source
tree, to compare two trees on the same card.

    python scripts/gibbs_sweep_ab.py TREE [--m 50000] [--n 1410]

TREE is the root of a checkout (this one: ``.``). The script imports that
tree's ``janusx_tpu_torch`` (its kernels are built on first use into the
tree's ``build/``), makes a seeded standardized panel of n samples x m
SNPs on the card, and prints one JSON line: CUDA-event ms of one BayesB
sweep of G1 and one sweep of G2 (mean over 5 after 1), at n samples and
at 32 (one CTA: the serial chain alone). Run it once per tree, in the
order A B B A, inside one call on one card; times from different calls
are not comparable.
"""
import argparse
import json
import os
import sys

import numpy as np


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tree")
    ap.add_argument("--m", type=int, default=50_000)
    ap.add_argument("--n", type=int, default=1410)
    args = ap.parse_args()
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)
    import torch

    from janusx_tpu_torch import config
    from janusx_tpu_torch.gs.bayes import GeneratorDraws, block_markers
    from janusx_tpu_torch.ops import kernels

    if not kernels.__file__.startswith(root):
        raise SystemExit(f"imported {kernels.__file__}, not the tree at {root}")
    config.set_full_f32_matmul()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(1)
    g = rng.binomial(2, rng.uniform(0.05, 0.5, args.m), size=(args.n, args.m))
    g = torch.as_tensor(g.astype(np.float32), device=dev)
    Z = (g - g.mean(0)) / g.std(0).clamp_min(1e-6)
    del g

    def ms(fn, iters: int = 5) -> float:
        fn()
        torch.cuda.synchronize()
        t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        torch.cuda.synchronize()
        return t0.elapsed_time(t1) / iters

    out = {}
    for tag, Zs in ((f"n{args.n}", Z), ("n32", Z[:32])):
        Zb, Gb, x2 = block_markers(Zs)
        nb, C, n = Zb.shape
        _, rn, ru, rca, rci = GeneratorDraws(5, dev, 5.0).sweep(nb, C, "B")
        beta = torch.zeros((nb, C), device=dev)
        var_b = torch.full((nb, C), 0.01, device=dev)
        r = torch.randn(n, device=dev)
        scal = torch.tensor([0.5, 0.01, 0.5, 0.07, 0.01], device=dev)
        out[tag] = {
            "gibbs_sweep_marker": ms(lambda: kernels.gibbs_sweep_marker(
                Zb, Gb, x2, beta, var_b, rn, ru, rca, rci, r, scal, "B")),
            "gibbs_sweep_block_mvn": ms(lambda: kernels.gibbs_sweep_block_mvn(
                Zb, Gb, x2, beta, var_b, rn, rca, r, scal))}
    print(json.dumps({"tree": args.tree, "m": args.m, "ms": out}), flush=True)


if __name__ == "__main__":
    main()
