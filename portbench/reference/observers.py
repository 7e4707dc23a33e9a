"""Heliocentric observer positions (equatorial J2000, AU) at epochs in
MJD (TT): the Earth from the frozen analytic ephemeris, plus the station's
geocentric position when the traffic names stations."""

from portbench.reference.ephem import earth_equatorial


def heliocentric(mjd, station, stations=None):
    """``mjd`` (..., ) float64; ``station`` (...,) indices into ``stations``
    (a dict of arrays, see :mod:`portbench.reference.frames`), or None for
    the geocenter."""
    pos = earth_equatorial(mjd)
    if stations is not None:
        from portbench.reference.frames import station_equatorial

        pos = pos + station_equatorial(mjd, station, stations)
    return pos
