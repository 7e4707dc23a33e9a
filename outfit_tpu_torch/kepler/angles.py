"""Angle helpers.  Port of ``outfit_tpu/kepler/angles.py``."""

import torch

from outfit_tpu_torch.constants import DPI
from outfit_tpu_torch.utils.tensors import as_float


def principal_angle(angle):
    """Wrap an angle to [0, 2pi)."""
    a = as_float(angle)
    return a - torch.floor(a / DPI) * DPI
