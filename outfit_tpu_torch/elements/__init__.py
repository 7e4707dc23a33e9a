"""Orbital element sets, two-body propagation with partials, uncertainties."""

from outfit_tpu_torch.elements.orb_elem import ccek1, eccentricity_control
from outfit_tpu_torch.elements.twobody import TwoBodyResult, propagate_twobody, solve_generalized_kepler
from outfit_tpu_torch.elements.types import (
    CometaryElements,
    EquinoctialElements,
    EquinoctialLimits,
    KeplerianElements,
    cometary_to_equinoctial,
    cometary_to_keplerian,
    equinoctial_to_keplerian,
    is_bizarre,
    jacobian_cometary_to_equinoctial,
    jacobian_cometary_to_keplerian,
    jacobian_equinoctial_to_keplerian,
    jacobian_keplerian_to_equinoctial,
    keplerian_to_equinoctial,
)
from outfit_tpu_torch.elements.uncertainty import propagate_covariance, uncertainties_from_covariance

__all__ = [
    "CometaryElements",
    "EquinoctialElements",
    "EquinoctialLimits",
    "KeplerianElements",
    "TwoBodyResult",
    "ccek1",
    "cometary_to_equinoctial",
    "cometary_to_keplerian",
    "eccentricity_control",
    "equinoctial_to_keplerian",
    "is_bizarre",
    "jacobian_cometary_to_equinoctial",
    "jacobian_cometary_to_keplerian",
    "jacobian_equinoctial_to_keplerian",
    "jacobian_keplerian_to_equinoctial",
    "keplerian_to_equinoctial",
    "propagate_covariance",
    "propagate_twobody",
    "solve_generalized_kepler",
    "uncertainties_from_covariance",
]
