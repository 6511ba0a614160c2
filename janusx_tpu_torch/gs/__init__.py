"""Genomic selection: GBLUP/rrBLUP/Bayes/ML models, K-fold CV, workflows."""

from janusx_tpu_torch.gs.metrics import regression_metrics
from janusx_tpu_torch.gs.kfold import KFold
from janusx_tpu_torch.gs.blup import GblupModel, fit_gblup, predict_gblup

__all__ = [
    "regression_metrics",
    "KFold",
    "GblupModel",
    "fit_gblup",
    "predict_gblup",
]
