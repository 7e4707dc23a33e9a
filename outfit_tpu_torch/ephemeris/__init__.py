"""Ephemeris generation: apparent positions and observation geometry.

The request/result API (Position / Geometry / Combined outputs, Single /
Range / At epoch modes), the apparent-position core with first- and
second-order aberration, and observation geometry (phase angle, solar
elongation, radial velocity, angular rates).  The core is batched over
(observer, epoch) pairs.
"""

from outfit_tpu_torch.ephemeris.config import AberrationOrder, EphemerisConfig  # noqa: F401
from outfit_tpu_torch.ephemeris.request import (  # noqa: F401
    Combined,
    EphemerisMode,
    EphemerisRequest,
    Geometry,
    Position,
)
from outfit_tpu_torch.ephemeris.result import EphemerisEntry, EphemerisResult  # noqa: F401
from outfit_tpu_torch.ephemeris.compute import ApparentPosition, BodyGeometry  # noqa: F401
from outfit_tpu_torch.ephemeris.api import compute_ephemeris  # noqa: F401
from outfit_tpu_torch.ephemeris.api import compute_ephemerides_for_results  # noqa: F401
from outfit_tpu_torch.ephemeris.batch import (  # noqa: F401
    EphemerisTable,
    compute_ephemerides_batch,
)
