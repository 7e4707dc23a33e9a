# Source: outfit_tpu/ephemeris/request.py (copied; imports retargeted to this package).
"""Ephemeris request: observers x epoch modes.

Parity: ``EphemerisRequest``/``EphemerisMode``/``ObserverRequest``
(``src/ephemeris/request.rs:91-347``).  The reference's sealed output-kind
markers (Position / Geometry / Combined) become the ``output`` string field;
the compute core always produces both cheaply, so Combined is the natural
batched default and the others are views.
"""

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple, Union

import numpy as np

from outfit_tpu_torch.ephemeris.config import EphemerisConfig
from outfit_tpu_torch.observations.observatories import Observer

#: Output-kind markers (parity: the sealed ``EphemerisOutputKind`` marker
#: types Position / Geometry / Combined, request.rs:91-141).  The batched
#: compute core always evaluates both cheaply; the marker selects what the
#: entry ``value`` carries: an ``ApparentPosition``, a ``BodyGeometry``, or
#: the combined view.
Position = "position"
Geometry = "geometry"
Combined = "combined"

#: name-parity alias: the set of valid output-kind markers
EphemerisOutputKind = frozenset({Position, Geometry, Combined})


@dataclass(frozen=True)
class EphemerisMode:
    """Single(epoch) | Range{start, end, step} | At[epochs] (MJD TT).

    Parity: request.rs:217-274.
    """

    epochs: Tuple[float, ...]

    @classmethod
    def single(cls, epoch: float) -> "EphemerisMode":
        return cls((float(epoch),))

    @classmethod
    def range(cls, start: float, end: float, step: float) -> "EphemerisMode":
        n = int(np.floor((end - start) / step + 1e-9)) + 1
        return cls(tuple(start + i * step for i in range(max(n, 0))))

    @classmethod
    def at(cls, epochs: Sequence[float]) -> "EphemerisMode":
        return cls(tuple(float(e) for e in epochs))


@dataclass
class ObserverRequest:
    observer: Observer
    mode: EphemerisMode


@dataclass
class EphemerisRequest:
    """Built by chaining: ``EphemerisRequest(config).add(observer, mode)``.

    ``output`` selects the entry value type (parity: the reference's
    ``EphemerisRequest<Position|Geometry|Combined>`` type parameter,
    request.rs:91-141): :data:`Position` -> ``ApparentPosition``,
    :data:`Geometry` -> ``BodyGeometry``, :data:`Combined` (default) ->
    an ``EphemerisValue`` carrying both views.
    """

    config: EphemerisConfig = field(default_factory=EphemerisConfig)
    entries: List[ObserverRequest] = field(default_factory=list)
    output: str = Combined

    def __post_init__(self):
        if self.output not in EphemerisOutputKind:
            raise ValueError(
                f"output must be one of {sorted(EphemerisOutputKind)}, "
                f"got {self.output!r}"
            )

    def add(self, observer: Observer, mode: Union[EphemerisMode, Sequence[float]]) -> "EphemerisRequest":
        if not isinstance(mode, EphemerisMode):
            mode = EphemerisMode.at(mode)
        self.entries.append(ObserverRequest(observer, mode))
        return self

    def __len__(self) -> int:
        return sum(len(e.mode.epochs) for e in self.entries)
