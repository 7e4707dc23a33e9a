"""Universal-variable Kepler solver, Stumpff functions and angle helpers."""

from outfit_tpu_torch.kepler.angles import angle_diff, principal_angle
from outfit_tpu_torch.kepler.stumpff import s_funct
from outfit_tpu_torch.kepler.universal import (
    KeplerParams,
    SolverConfig,
    prelim_kepuni,
    propagate_universal,
    solve_kepuni,
    velocity_correction,
)

__all__ = [
    "KeplerParams",
    "SolverConfig",
    "angle_diff",
    "prelim_kepuni",
    "principal_angle",
    "propagate_universal",
    "s_funct",
    "solve_kepuni",
    "velocity_correction",
]
