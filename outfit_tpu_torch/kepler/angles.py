"""Angle helpers.  Port of ``outfit_tpu/kepler/angles.py``."""

import math

import torch

from outfit_tpu_torch.constants import DPI
from outfit_tpu_torch.utils.tensors import as_float, as_floats


def principal_angle(angle):
    """Wrap an angle to [0, 2pi)."""
    a = as_float(angle)
    return a - torch.floor(a / DPI) * DPI


def angle_diff(a, b):
    """Principal difference b - a wrapped to (-pi, pi]."""
    b, a = as_floats(b, a)
    d = principal_angle(b - a)
    return torch.where(d > math.pi, d - DPI, d)
