# Source: outfit_tpu/propagator/config.py (copied; imports retargeted to this package).
"""Propagator configuration.

Parity: ``PropagatorKind`` / ``NBodyConfig`` (``src/propagator/mod.rs``):
default perturber list [Sun], abs/rel tolerances 1e-12.  Frozen and
hashable.
"""

from dataclasses import dataclass
from typing import Tuple

from outfit_tpu_torch.ephem.bodies import Body


@dataclass(frozen=True)
class NBodyConfig:
    """Perturbing bodies + DOP853 tolerances (parity: mod.rs:132-162).

    The Sun must be included for the central two-body term: the dynamics
    treat every body uniformly (the Sun's direct term is the Keplerian
    acceleration).
    """

    perturbing_bodies: Tuple[int, ...] = (int(Body.SUN),)
    abs_tol: float = 1e-12
    rel_tol: float = 1e-12
    max_steps: int = 1000
    #: True = perturber positions snapshot at t0 (reference parity,
    #: nbody.rs:73-87; accurate for arcs <~30 d).  False = positions
    #: interpolated from the ephemeris tables at every integrator stage
    #: time, accurate for arbitrarily long arcs
    frozen_perturbers: bool = True

    @classmethod
    def with_planets(cls) -> "NBodyConfig":
        """Sun + the eight planets (+ Pluto's barycenter)."""
        return cls(
            perturbing_bodies=tuple(
                int(b)
                for b in (
                    Body.SUN,
                    Body.MERCURY_BARY,
                    Body.VENUS_BARY,
                    Body.EMB,
                    Body.MARS_BARY,
                    Body.JUPITER_BARY,
                    Body.SATURN_BARY,
                    Body.URANUS_BARY,
                    Body.NEPTUNE_BARY,
                    Body.PLUTO_BARY,
                )
            )
        )


@dataclass(frozen=True)
class PropagatorKind:
    """TwoBody (default) or NBody(config).  Parity: mod.rs:27-35."""

    nbody: bool = False
    config: NBodyConfig = NBodyConfig()

    @classmethod
    def two_body(cls) -> "PropagatorKind":
        return cls(nbody=False)

    # --- serde-feature analogue (Cargo.toml:67,81) --------------------------
    def to_dict(self) -> dict:
        from dataclasses import asdict

        d = asdict(self)
        d["config"] = dict(d["config"], perturbing_bodies=list(
            self.config.perturbing_bodies
        ))
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "PropagatorKind":
        d = dict(d)
        if isinstance(d.get("config"), dict):
            c = dict(d["config"])
            if "perturbing_bodies" in c:
                c["perturbing_bodies"] = tuple(int(b) for b in c["perturbing_bodies"])
            d["config"] = NBodyConfig(**c)
        return cls(**d)

    @classmethod
    def n_body(cls, config: NBodyConfig = NBodyConfig()) -> "PropagatorKind":
        return cls(nbody=True, config=config)
