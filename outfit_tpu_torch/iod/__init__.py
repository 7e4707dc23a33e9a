"""Gauss initial orbit determination, batched."""

from outfit_tpu_torch.iod.api import FitResult, fit_full_iod, fit_full_iod_parallel, fit_full_iod_stream, fit_iod
from outfit_tpu_torch.iod.params import IODParams

__all__ = ["FitResult", "IODParams", "fit_full_iod", "fit_full_iod_parallel", "fit_full_iod_stream", "fit_iod"]
