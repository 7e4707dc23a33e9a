"""Observer geometry and the per-dataset observer cache."""

from outfit_tpu_torch.observer.cache import ObserverCache
from outfit_tpu_torch.observer.geometry import (
    earth_fixed_position,
    earth_fixed_velocity,
    helio_position,
    helio_velocity,
    pvobs,
)

__all__ = [
    "ObserverCache",
    "earth_fixed_position",
    "earth_fixed_velocity",
    "helio_position",
    "helio_velocity",
    "pvobs",
]
