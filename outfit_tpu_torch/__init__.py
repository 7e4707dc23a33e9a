"""outfit_tpu_torch: the PyTorch/CUDA port of outfit_tpu.

This slice covers the main path in its production form,
``fit_lsq(dataset, ephem, IODParams(), config, seed=..., device=...)``:
observation ingestion, the observer cache (with the Chebyshev table
evaluation as a hand-written CUDA kernel for Hopper, ``csrc/chebyshev.cu``),
Gauss initial orbit determination (``fit_full_iod``, ``fit_iod``: triplet
enumeration, Aberth roots, the f-g correction over the universal Kepler
solver, RMS scoring), and the differential correction (two-body propagation
with analytic partials, the Newton / outlier-rejection loops, covariance
extraction), seeded by the IOD or by ``initial_orbits``; in float64 or, with
``precision="mixed"``, with float32 iterative stages and float64 polish;
results as dicts or as an ``LsqTable``; and the service modes
(``fit_lsq_stream``, ``fit_lsq_escalating``, ``fit_lsq_stream_escalating``,
``fit_full_iod_stream``).  Ingestion from files: DE ephemerides
(``JPLEphem("horizon:DE440", path=...)``, ``JPLEphem("naif:DE440",
path=...)``), MPC 80-column files (a native C parser or Python), ADES XML,
dataframes and parquet, and star-catalog debiasing
(``ObsDataset.apply_debias``).  Beside the fitting path: N-body propagation
(``propagate_nbody``: DOP853 with the state transition matrix, frozen or
moving perturbers, also as the correction's propagator through
``PropagatorKind.n_body``) and ephemeris generation (``compute_ephemeris``,
``compute_ephemerides_for_results``, ``compute_ephemerides_batch``).  The
package imports ``torch`` and never ``jax``.
"""

from outfit_tpu_torch import constants
from outfit_tpu_torch.constants import (
    AU,
    GAUSS_GRAV,
    GAUSS_GRAV_SQUARED,
    RADEG,
    RADH,
    RADSEC,
    SECONDS_PER_DAY,
    T2000,
    VLIGHT_AU,
)
from outfit_tpu_torch.elements.types import (
    CometaryElements,
    EquinoctialElements,
    EquinoctialLimits,
    KeplerianElements,
    OrbitalElements,
)
from outfit_tpu_torch.ephem.api import JPLEphem
from outfit_tpu_torch.ephem.bodies import Body
from outfit_tpu_torch.ephemeris.api import (
    FullOrbitResultExt,
    compute_ephemerides_for_results,
    compute_ephemeris,
)
from outfit_tpu_torch.ephemeris.batch import EphemerisTable, compute_ephemerides_batch
from outfit_tpu_torch.ephemeris.compute import ApparentPosition, BodyGeometry
from outfit_tpu_torch.ephemeris.config import AberrationOrder, EphemerisConfig
from outfit_tpu_torch.ephemeris.request import (
    Combined,
    EphemerisMode,
    EphemerisRequest,
    Geometry,
    ObserverRequest,
    Position,
)
from outfit_tpu_torch.ephemeris.result import EphemerisEntry, EphemerisResult
from outfit_tpu_torch.errors import OutfitError
from outfit_tpu_torch.iod.api import (
    IODRMS,
    FitResult,
    FullOrbitResult,
    GaussResult,
    fit_full_iod,
    fit_full_iod_parallel,
    fit_full_iod_stream,
    fit_iod,
)
from outfit_tpu_torch.iod.params import IODParams
from outfit_tpu_torch.lsq.api import (
    DifferentialCorrectionOutput,
    LsqResult,
    fit_lsq,
    fit_lsq_escalating,
    fit_lsq_stream,
    fit_lsq_stream_escalating,
)
from outfit_tpu_torch.lsq.config import DifferentialCorrectionConfig
from outfit_tpu_torch.lsq.table import LsqTable
from outfit_tpu_torch.observations.dataset import ObsDataset
from outfit_tpu_torch.observations.error_model import ErrorModel
from outfit_tpu_torch.observations.observatories import Observer, get_observatory
from outfit_tpu_torch.propagator import NBodyConfig, PropagatorKind, dop853_integrate, propagate_nbody
from outfit_tpu_torch.time.scales import Ut1Provider

__version__ = "0.2.0"

__all__ = [
    "AU",
    "AberrationOrder",
    "ApparentPosition",
    "Body",
    "BodyGeometry",
    "Combined",
    "CometaryElements",
    "DifferentialCorrectionConfig",
    "DifferentialCorrectionOutput",
    "EphemerisConfig",
    "EphemerisEntry",
    "EphemerisMode",
    "EphemerisRequest",
    "EphemerisResult",
    "EphemerisTable",
    "EquinoctialElements",
    "EquinoctialLimits",
    "ErrorModel",
    "FitResult",
    "FullOrbitResult",
    "FullOrbitResultExt",
    "GAUSS_GRAV",
    "GAUSS_GRAV_SQUARED",
    "GaussResult",
    "Geometry",
    "IODParams",
    "IODRMS",
    "JPLEphem",
    "KeplerianElements",
    "LsqResult",
    "LsqTable",
    "NBodyConfig",
    "ObsDataset",
    "Observer",
    "ObserverRequest",
    "OrbitalElements",
    "OutfitError",
    "Position",
    "PropagatorKind",
    "RADEG",
    "RADH",
    "RADSEC",
    "SECONDS_PER_DAY",
    "T2000",
    "Ut1Provider",
    "VLIGHT_AU",
    "compute_ephemerides_batch",
    "compute_ephemerides_for_results",
    "compute_ephemeris",
    "constants",
    "dop853_integrate",
    "fit_full_iod",
    "fit_full_iod_parallel",
    "fit_full_iod_stream",
    "fit_iod",
    "fit_lsq",
    "fit_lsq_escalating",
    "fit_lsq_stream",
    "fit_lsq_stream_escalating",
    "get_observatory",
    "propagate_nbody",
]
