"""Observation ingestion (MPC 80-column, native or Python; ADES; dataframes
and parquet), star-catalog debiasing, the observatory catalog and error
models."""

from outfit_tpu_torch.observations.dataset import ObsDataset, Observation
from outfit_tpu_torch.observations.debias import DebiasTable
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observations.observatories import Observer, get_observatory

__all__ = ["DebiasTable", "ErrorModel", "ObsDataset", "Observation", "Observer", "get_observatory"]
