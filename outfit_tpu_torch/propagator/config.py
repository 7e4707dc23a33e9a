# Source: outfit_tpu/propagator/config.py (trimmed: two-body only).
"""Propagator configuration.  ``PropagatorKind.n_body`` exists so a config
can name it; the port runs the two-body propagator only and raises for
N-body (ROADMAP: port queue, N-body)."""

from dataclasses import dataclass


@dataclass(frozen=True)
class PropagatorKind:
    """TwoBody (default) or NBody."""

    nbody: bool = False

    @classmethod
    def two_body(cls) -> "PropagatorKind":
        return cls(nbody=False)

    @classmethod
    def n_body(cls) -> "PropagatorKind":
        return cls(nbody=True)
