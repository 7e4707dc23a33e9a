# Source: outfit_tpu/ephem/resolver.py (without download_file: the port never fetches).
"""Ephemeris source resolution: source strings -> official URLs -> cache paths.

* source strings ``"horizon:DE440"`` / ``"naif:DE440"`` with per-backend
  version tables,
* official JPL/NAIF base URLs,
* OS cache layout ``<cache root>/outfit_cache/jpl_ephem/{jpl_horizon|naif}/
  <filename>``, including the quirk of caching Horizon legacy binaries
  under their NAIF-style ``DE440.bsp`` name,
* resolve = return the cached path if present; otherwise raise
  ``JPLFileNotFound`` naming the cache path and the URL to fetch by hand.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass

from outfit_tpu_torch.errors import (
    InvalidJPLEphemFileVersion,
    InvalidJPLStringFormat,
    JPLFileNotFound,
)

#: Horizon (legacy DE binary) versions -> official path fragment under
#: HORIZON_BASE_URL
HORIZON_FILES = {
    "DE102": "de102/lnxm1410p3002.102",
    "DE200": "de200/lnxm1600p2170.200",
    "DE202": "de202/lnxp1900p2050.202",
    "DE403": "de403/lnxp1600p2200.403",
    "DE405": "de405/lnxp1600p2200.405",
    "DE406": "de406/lnxm3000p3000.406",
    "DE410": "de410/lnxp1960p2020.410",
    "DE413": "de413/lnxp1900p2050.413",
    "DE414": "de414/lnxp1600p2200.414",
    "DE418": "de418/lnxp1900p2050.418",
    "DE421": "de421/lnxp1900p2053.421",
    "DE422": "de422/lnxm3000p3000.422",
    "DE423": "de423/lnxp1800p2200.423",
    "DE430": "de430/linux_p1550p2650.430",
    "DE430t": "de430t/linux_p1550p2650.430t",
    "DE431": "de431/lnxm13000p17000.431",
    "DE440": "de440/linux_p1550p2650.440",
    "DE440t": "de440t/linux_p1550p2650.440t",
    "DE441": "de441/linux_m13000p17000.441",
}

#: NAIF SPK versions -> canonical kernel filename (case-sensitive, with the
#: split DE431/DE441 parts)
NAIF_FILES = {
    "DE430": "de430.bsp",
    "DE431_part-1": "de431_part-1.bsp",
    "DE431_part-2": "de431_part-2.bsp",
    "DE432": "de432.bsp",
    "DE435": "de435.bsp",
    "DE438": "de438.bsp",
    "DE440": "de440.bsp",
    "DE440s": "de440s.bsp",
    "DE441_part-1": "de441_part-1.bsp",
    "DE441_part-2": "de441_part-2.bsp",
    "DE442": "de442.bsp",
}

HORIZON_BASE_URL = "https://ssd.jpl.nasa.gov/ftp/eph/planets/Linux/"
NAIF_BASE_URL = "https://naif.jpl.nasa.gov/pub/naif/generic_kernels/spk/planets/"


@dataclass(frozen=True)
class EphemFileSource:
    """Parsed ``"{source}:{version}"`` selector."""

    scheme: str  # "horizon" | "naif"
    version: str  # validated against the backend's version table

    @classmethod
    def parse(cls, source: str) -> "EphemFileSource":
        parts = source.split(":")
        if len(parts) != 2:
            raise InvalidJPLStringFormat(
                "Expected format: {source}:{version}, example: 'naif:DE440' "
                "or 'horizon:DE440'"
            )
        scheme, version = parts[0].lower(), parts[1]
        if scheme == "horizon":
            if version not in HORIZON_FILES:
                raise InvalidJPLEphemFileVersion(f"Invalid JPL Horizon version: {version}")
        elif scheme == "naif":
            if version not in NAIF_FILES:
                raise InvalidJPLEphemFileVersion(f"Invalid NAIF version: {version}")
        else:
            raise InvalidJPLStringFormat(f"Unknown ephemeris file source: {parts[0]}")
        return cls(scheme, version)

    @property
    def url(self) -> str:
        """Official download URL."""
        if self.scheme == "horizon":
            return HORIZON_BASE_URL + HORIZON_FILES[self.version]
        return NAIF_BASE_URL + NAIF_FILES[self.version]

    @property
    def cache_subdir(self) -> str:
        """Backend subdirectory under the cache root."""
        return "jpl_horizon" if self.scheme == "horizon" else "naif"

    @property
    def filename(self) -> str:
        """Local cache filename: the Horizon arm caches under the NAIF-style
        name (``DE440.bsp``), the NAIF arm under the canonical kernel name
        (``de440.bsp``)."""
        if self.scheme == "horizon":
            return self.version + ".bsp"
        return NAIF_FILES[self.version]

    def cache_path(self, cache_root: str | None = None) -> str:
        """``<cache root>/outfit_cache/jpl_ephem/<subdir>/<filename>``."""
        root = cache_root or os_cache_root()
        return os.path.join(root, "outfit_cache", "jpl_ephem", self.cache_subdir, self.filename)


def os_cache_root() -> str:
    """Per-OS user cache root: $XDG_CACHE_HOME or ~/.cache on Linux,
    ~/Library/Caches on macOS, %LOCALAPPDATA% on Windows."""
    if sys.platform == "darwin":
        return os.path.expanduser("~/Library/Caches")
    if os.name == "nt":
        return os.environ.get("LOCALAPPDATA", os.path.expanduser(r"~\AppData\Local"))
    return os.environ.get("XDG_CACHE_HOME", os.path.expanduser("~/.cache"))


def validate_ephemeris_bytes(path: str, scheme: str) -> bool:
    """Cheap integrity check on a DE binary: at least 1 MiB; NAIF kernels
    open with the DAF magic ``DAF/``, Horizon legacy binaries carry the
    title strings ``JPL Planetary Ephemeris``."""
    try:
        if os.path.getsize(path) < (1 << 20):
            return False
        with open(path, "rb") as fh:
            head = fh.read(256)
    except OSError:
        return False
    if scheme == "naif":
        return head.startswith(b"DAF/")
    return b"JPL" in head and b"Ephemeris" in head


def resolve_ephemeris_file(
    source: str | EphemFileSource,
    download: bool = True,
    cache_root: str | None = None,
) -> str:
    """Resolve a source selector to a local file path.

    A cache hit returns the path.  A miss raises ``JPLFileNotFound`` naming
    the cache path and the URL, whatever ``download`` says: the port never
    fetches (``download`` is kept for the JAX package's signature)."""
    src = source if isinstance(source, EphemFileSource) else EphemFileSource.parse(source)
    path = src.cache_path(cache_root)
    if os.path.exists(path):
        return path
    raise JPLFileNotFound(
        f"{src.scheme}:{src.version} is not cached at {path} "
        f"(downloads disabled); fetch {src.url} manually"
    )
