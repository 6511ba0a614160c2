"""The numbers that decide ``correct``: the widest gaps between what the
timed path produced and what the plain reference computes, over every SNP
of every checked trait.

- ``invalid_mismatch``: SNPs valid (finite beta and se) on one side only;
  an exact comparison.
- ``sign_mismatch``: SNPs whose beta has the other sign than the
  reference's, among those the reference puts at least ``SIGN_Z`` of its se
  from zero; an exact comparison (sound runs of the dense cell miss the
  reference's beta by at most 8.3e-04 of se, PERF.md).
- ``se_rel_gap``: max |se / se_ref - 1|.
- ``beta_gap_se``: max |beta - beta_ref| / se_ref.
- ``logp_gap``: max |log10 p - log10 p_ref|.
- ``lambda_log10_gap``: max |log10 λ_null - log10 λ_null,ref|.
- ``gamma_rel_gap``: max |γ / γ_ref - 1| (the GRAMMAR route's γ).

A trait whose output has another length than the reference's reads inf.
A cell's limits file names the numbers its check compares.
"""

from __future__ import annotations

import numpy as np

SIGN_Z = 0.01


def gaps(prog: list[dict], ref: list[dict]) -> dict:
    out = {"invalid_mismatch": 0.0, "sign_mismatch": 0.0, "se_rel_gap": 0.0, "beta_gap_se": 0.0,
           "logp_gap": 0.0, "lambda_log10_gap": 0.0}
    if "gamma" in ref[0]:
        out["gamma_rel_gap"] = 0.0
    for a, b in zip(prog, ref):
        if a is None or len(a["beta"]) != len(b["beta"]):
            return {k: float("inf") for k in out}
        va = np.isfinite(a["beta"]) & np.isfinite(a["se"])
        vb = np.isfinite(b["beta"]) & np.isfinite(b["se"])
        out["invalid_mismatch"] += float(np.sum(va != vb))
        both = va & vb
        with np.errstate(divide="ignore", invalid="ignore"):
            away = np.abs(b["beta"]) >= SIGN_Z * b["se"]
        out["sign_mismatch"] += float(np.sum(both & away & (np.sign(a["beta"]) != np.sign(b["beta"]))))
        with np.errstate(divide="ignore", invalid="ignore"):
            se = np.abs(a["se"][both] / b["se"][both] - 1.0)
            bt = np.abs(a["beta"][both] - b["beta"][both]) / b["se"][both]
            lp = np.abs(np.log10(a["p"]) - np.log10(b["p"]))
        for k, v in (("se_rel_gap", se), ("beta_gap_se", bt), ("logp_gap", lp)):
            if v.size:
                out[k] = max(out[k], float(np.max(np.where(np.isnan(v), np.inf, v))))
        out["lambda_log10_gap"] = max(out["lambda_log10_gap"],
                                      abs(np.log10(a["lam"]) - np.log10(b["lam"])))
        if "gamma_rel_gap" in out:
            out["gamma_rel_gap"] = max(out["gamma_rel_gap"], abs(a["gamma"] / b["gamma"] - 1.0))
    return out
