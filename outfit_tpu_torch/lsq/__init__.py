"""Differential orbit correction (weighted least squares), batched."""

from outfit_tpu_torch.lsq.api import (
    LsqResult,
    PendingLsq,
    fit_lsq,
    fit_lsq_dispatch,
    fit_lsq_escalating,
    fit_lsq_finalize,
    fit_lsq_stream,
    fit_lsq_stream_escalating,
)
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig, OutlierRejectionConfig
from outfit_tpu_torch.lsq.table import LsqTable

__all__ = [
    "DifferentialCorrectionConfig",
    "LsqResult",
    "LsqTable",
    "OutlierRejectionConfig",
    "PendingLsq",
    "fit_lsq",
    "fit_lsq_dispatch",
    "fit_lsq_escalating",
    "fit_lsq_finalize",
    "fit_lsq_stream",
    "fit_lsq_stream_escalating",
]
