# Source: outfit_tpu/iod/api.py:56-97 (the FitResult dataclass only, as the seed type).
"""Initial-orbit results.  Gauss IOD itself is not ported yet; the seeded
least-squares path takes these as its starting orbits."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

#: ``FitResult.kind`` of a Keplerian element set (1 = cometary)
KIND_KEPLERIAN = 0


@dataclass(slots=True)
class FitResult:
    """Per-trajectory IOD outcome (parity: FitOrbitResult::IODGauss)."""

    traj_id: str
    ok: bool
    error: Optional[str] = None
    rms: float = float("inf")
    corrected: bool = False
    epoch: float = 0.0
    kind: int = KIND_KEPLERIAN  # 0 = Keplerian, 1 = Cometary
    elements: Optional[np.ndarray] = None  # (6,) element set of ``kind``
    equinoctial: Optional[np.ndarray] = None  # (6,) a,h,k,p,q,lambda (ecliptic)
