# Source: outfit_tpu/ephemeris/result.py (copied; imports retargeted to this package).
"""Ephemeris result containers.

Parity: ``EphemerisEntry`` / ``EphemerisResult``
(``src/ephemeris/result.rs:52-195``): per-entry errors are values, never
thrown; success/error/by-observer iterators.
"""

from dataclasses import dataclass
from typing import Generic, Iterator, List, Optional, TypeVar

from outfit_tpu_torch.observations.observatories import Observer

T = TypeVar("T")


@dataclass
class EphemerisEntry(Generic[T]):
    epoch: float  # MJD TT
    observer: Observer
    value: Optional[T] = None
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclass
class EphemerisResult(Generic[T]):
    entries: List[EphemerisEntry[T]]

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[EphemerisEntry[T]]:
        return iter(self.entries)

    def success_count(self) -> int:
        return sum(1 for e in self.entries if e.ok)

    def error_count(self) -> int:
        return sum(1 for e in self.entries if not e.ok)

    def successes(self) -> Iterator[EphemerisEntry[T]]:
        return (e for e in self.entries if e.ok)

    def errors(self) -> Iterator[EphemerisEntry[T]]:
        return (e for e in self.entries if not e.ok)

    def by_observer(self, observer: Observer) -> Iterator[EphemerisEntry[T]]:
        return (e for e in self.entries if e.observer == observer)
