# Source: outfit_tpu/errors.py (trimmed to the classes this package raises or names).
"""Error taxonomy.

Inside the batched tensor code errors are DATA (integer status codes and
validity masks), so lanes fail independently.  At the host API boundary
they are the exceptions below, or structured error strings on the
per-trajectory results built from the result-error class names.
"""


class OutfitError(Exception):
    """Base class for host-side errors."""


# -- raised at the host API boundary -----------------------------------------


class InvalidRefSystem(OutfitError, ValueError):
    """Invalid rotation-axis index / non-converging rotpn chain."""


class InvalidIODParameter(OutfitError, ValueError):
    """IODParams / config validation failure."""


class InvalidErrorModel(OutfitError, ValueError):
    """Unknown astrometric error-model name."""


class UnknownObservatory(OutfitError, KeyError):
    """MPC observatory code absent from the catalog."""


class TrajectoryIdNotFound(OutfitError, KeyError):
    """Requested trajectory id is not in the dataset."""


class InvalidJPLStringFormat(OutfitError, ValueError):
    """Ephemeris source string is not 'scheme:NAME'."""


class JPLFileNotFound(OutfitError, FileNotFoundError):
    """Resolved ephemeris path does not exist (the port never downloads)."""


class InvalidJPLEphemFileVersion(OutfitError, ValueError):
    """Ephemeris binary has an unsupported format / layout."""


class InvalidSpkDataType(OutfitError, ValueError):
    """DAF/SPK segment data type is not Type 2 / Type 3."""


class EphemerisBodyNotSupported(OutfitError, KeyError):
    """No ephemeris segment/table for the requested body."""


# -- per-trajectory result errors (stored as strings, never raised from the
#    batch pipelines) ----------------------------------------------------------


class NoFeasibleTriplets(OutfitError):
    def __init__(self, span, n_obs, dt_min, dt_max):
        super().__init__(
            f"NoFeasibleTriplets(span={span:.3f}, n_obs={n_obs}, "
            f"dt_min={dt_min}, dt_max={dt_max})"
        )


class NoViableOrbit(OutfitError):
    def __init__(self, attempts, cause=None):
        msg = f"NoViableOrbit(attempts={attempts})"
        if cause:
            msg = f"NoViableOrbit(cause={cause}, attempts={attempts})"
        super().__init__(msg)
        self.cause = cause
        self.attempts = attempts


class BizarreOrbit(OutfitError):
    """Elements left the EquinoctialLimits box; LSQ status code 2."""


class DifferentialCorrectionDiverged(OutfitError):
    """RMS grew past the divergence ratio; LSQ status code 3."""


class DifferentialCorrectionFailed(OutfitError):
    """Normal-equation inversion failed; LSQ status code 4."""


class InvalidOrbit(OutfitError):
    """Ephemeris request on a non-elliptical orbit (e >= 1 precheck,
    observation_ephemeris.rs:288-296)."""
