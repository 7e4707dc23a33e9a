# Source: outfit_tpu/lsq/config.py (copied; imports retargeted to this package).
"""Differential-correction configuration, with the reference's defaults
(``DifferentialCorrectionConfig``, ``diff_cor.rs:78-192``;
``OutlierRejectionConfig``, ``outlier_rejection.rs:49-80``)."""

from dataclasses import dataclass
from typing import Tuple

from outfit_tpu_torch.elements.types import EquinoctialLimits
from outfit_tpu_torch.propagator.config import PropagatorKind


@dataclass(frozen=True)
class OutlierRejectionConfig:
    chi_squared_rejection_threshold: float = 25.0
    chi_squared_recovery_threshold: float = 9.0


@dataclass(frozen=True)
class DifferentialCorrectionConfig:
    max_newton_iterations: int = 30
    max_outlier_rejection_passes: int = 10
    convergence_threshold: float = 1e-4
    convergence_before_rejection_threshold: float = 2.0
    rms_stagnation_ratio: float = 0.98
    rms_divergence_ratio: float = 1.5
    max_stagnation_iterations: int = 3
    enable_outlier_rejection: bool = True
    outlier_rejection: OutlierRejectionConfig = OutlierRejectionConfig()
    orbital_limits: EquinoctialLimits = EquinoctialLimits()
    free_elements: Tuple[bool, bool, bool, bool, bool, bool] = (True,) * 6
    propagator: PropagatorKind = PropagatorKind.two_body()

    #: "f64" = every Newton iteration in float64 (reference parity);
    #: "mixed" = a float32 pre-warm phase (no outlier decisions, guarded
    #: advances only) runs the orbit to ~1e-3 correction norm, then the
    #: float64 loop (float32 Jacobians, float64 residuals) finishes from the
    #: warmed elements and one float64 linearization refreshes the
    #: covariance.  With an N-body propagator "mixed" runs the float64 loop.
    precision: str = "f64"

    #: iteration cap for the float32 pre-warm phase (mixed only).
    prewarm_max_iterations: int = 12

    #: Newton iterations exempt from the divergence ratio check (default 0 =
    #: exact reference behavior)
    divergence_grace_iterations: int = 0

    # --- serde-feature analogue (Cargo.toml:67,81): round-trippable dicts ---
    def to_dict(self) -> dict:
        from dataclasses import asdict

        d = asdict(self)
        d["outlier_rejection"] = asdict(self.outlier_rejection)
        d["orbital_limits"] = self.orbital_limits._asdict()
        d["propagator"] = self.propagator.to_dict()
        d["free_elements"] = list(self.free_elements)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "DifferentialCorrectionConfig":
        d = dict(d)
        if isinstance(d.get("outlier_rejection"), dict):
            d["outlier_rejection"] = OutlierRejectionConfig(**d["outlier_rejection"])
        if isinstance(d.get("orbital_limits"), dict):
            d["orbital_limits"] = EquinoctialLimits(**d["orbital_limits"])
        if isinstance(d.get("propagator"), dict):
            d["propagator"] = PropagatorKind.from_dict(d["propagator"])
        if "free_elements" in d:
            d["free_elements"] = tuple(d["free_elements"])
        return cls(**d)
