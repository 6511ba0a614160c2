"""Regression metric pack for GS fold/test evaluation.

Matches the reference metric definitions
(JanusX python/janusx/gs/workflow.py:881 _regression_metric_pack):
pearson, spearman, r2 = 1 - ss_res/ss_tot (0 when ss_tot == 0), mse, mae,
rmse, nrmse = rmse/std(y_true).
"""

from __future__ import annotations

import numpy as np
from scipy import stats as sp_stats


def regression_metrics(y_true, y_pred) -> dict[str, float]:
    yt = np.asarray(y_true, np.float64).reshape(-1)
    yp = np.asarray(y_pred, np.float64).reshape(-1)
    mask = np.isfinite(yt) & np.isfinite(yp)
    nan = float("nan")
    if mask.sum() == 0:
        return {k: nan for k in ("pearson", "spearman", "r2", "mse", "mae", "rmse", "nrmse")}
    yt, yp = yt[mask], yp[mask]
    n = len(yt)
    diff = yt - yp
    ss_res = float(np.sum(diff**2))
    mse = ss_res / max(1, n)
    mae = float(np.mean(np.abs(diff)))
    rmse = float(np.sqrt(mse))
    ss_tot = float(np.sum((yt - yt.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 0.0
    y_std = float(np.std(yt))
    nrmse = rmse / y_std if y_std > 0 else nan
    pear = spear = nan
    if n >= 2:
        try:
            pear = float(sp_stats.pearsonr(yt, yp).statistic)
        except Exception:
            pass
        try:
            spear = float(sp_stats.spearmanr(yt, yp).statistic)
        except Exception:
            pass
    return {
        "pearson": pear, "spearman": spear, "r2": r2,
        "mse": mse, "mae": mae, "rmse": rmse, "nrmse": nrmse,
    }
