"""GS model persistence: save fitted models, predict on new genotypes.

Reference analog: ``.jxmodel`` artifacts with reload
(gs/workflow.py:1276-1299). Every kernel/Bayes fit is exported in the
PORTABLE marker-effect form (per-SNP additive effects on the centered
dosage scale + training means + intercept), so prediction on a new panel
is allele-harmonized dosage algebra — no kinship with the training set
required.
"""

from __future__ import annotations

import json

import numpy as np

FORMAT_VERSION = 1


def save_marker_model(
    path: str,
    sites,
    effects: np.ndarray,
    train_means: np.ndarray,
    mu: float,
    method: str,
    meta: dict | None = None,
) -> None:
    np.savez_compressed(
        path,
        format_version=FORMAT_VERSION,
        chrom=sites.chrom.astype(str),
        pos=sites.pos,
        snp=sites.snp.astype(str),
        allele0=sites.allele0.astype(str),
        allele1=sites.allele1.astype(str),
        effect=np.asarray(effects, np.float64),
        train_mean=np.asarray(train_means, np.float64),
        mu=np.float64(mu),
        method=method,
        meta=json.dumps(meta or {}),
    )


def load_marker_model(path: str) -> dict:
    z = np.load(path, allow_pickle=False)
    return {k: z[k] for k in z.files}


def predict_new_panel(model: dict, gdata) -> tuple[np.ndarray, dict]:
    """gebv for a new GenotypeData panel.

    Sites matched by (chrom, pos, unordered allele pair) — split
    multi-allelics share a position, so a bare positional key would shadow
    all but one of them; swapped-allele sites flip dosage; mismatched or
    absent sites contribute their training-mean term (equivalent to mean
    imputation). Returns (pred (n,), report)."""
    key_to_idx = {}
    for i, (c, p, x, y_) in enumerate(zip(
        model["chrom"], model["pos"], model["allele0"], model["allele1"]
    )):
        key_to_idx[(str(c), int(p)) + tuple(sorted((str(x), str(y_))))] = i
    eff = model["effect"]
    means = model["train_mean"]
    mu = float(model["mu"])
    n = gdata.n
    pred = np.full(n, mu, np.float64)
    matched = swapped = mismatched = 0
    used = np.zeros(len(eff), bool)
    g = gdata.genotypes
    for j in range(gdata.m):
        a0, a1 = str(gdata.sites.allele0[j]), str(gdata.sites.allele1[j])
        key = (str(gdata.sites.chrom[j]), int(gdata.sites.pos[j])) + tuple(
            sorted((a0, a1))
        )
        i = key_to_idx.get(key)
        if i is None or used[i]:
            continue
        m0, m1 = str(model["allele0"][i]), str(model["allele1"][i])
        row = g[j].astype(np.float64)
        miss = row < 0
        if (a0, a1) == (m0, m1):
            matched += 1
        elif (a0, a1) == (m1, m0):
            row = 2.0 - row
            swapped += 1
        else:
            mismatched += 1
            continue
        row[miss] = means[i]
        pred += eff[i] * (row - means[i])
        used[i] = True
    report = {
        "matched": matched, "swapped": swapped, "mismatched": mismatched,
        "model_snps": len(eff), "used": int(used.sum()),
    }
    return pred, report
