"""Differential orbit correction (weighted least squares), batched."""

from outfit_tpu_torch.lsq.api import (
    LsqResult,
    fit_lsq,
    fit_lsq_escalating,
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
    "fit_lsq",
    "fit_lsq_escalating",
    "fit_lsq_stream",
    "fit_lsq_stream_escalating",
]
