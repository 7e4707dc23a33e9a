# Source: outfit_tpu/ephemeris/config.py (copied; imports retargeted to this package).
"""Ephemeris configuration.

Parity: ``EphemerisConfig`` (``src/ephemeris/mod.rs:129-142``) and
``AberrationOrder`` (``aberration.rs:60-75``).
"""

import enum
from dataclasses import dataclass

from outfit_tpu_torch.propagator.config import PropagatorKind


class AberrationOrder(enum.IntEnum):
    FIRST = 1
    SECOND = 2


@dataclass(frozen=True)
class EphemerisConfig:
    propagator: PropagatorKind = PropagatorKind.two_body()
    aberration: AberrationOrder = AberrationOrder.FIRST
