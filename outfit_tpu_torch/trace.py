"""Spans and counters: what the host does between its reads of the device.

The fit and propagation paths run as Python loops that launch kernels and
read the device once a trip (a loop's exit test), then copy their results
back.  This module counts those reads and times the host around them.

**Counters** (always on).  Every place where the fit or propagation path
waits for the device reads through a :class:`Site` of :data:`sites`: the
site does the read the code did (one read, as before), counts it and adds
the nanoseconds the thread was blocked in it.  At a loop's exit test the
same read also brings back the count of lanes still live: a read that
finds some live starts a trip, and the site adds the trip, the live lanes
and the lanes in all (live / lanes: the share of the work a trip does
that was still needed).  A loop that runs inside one kernel, each lane to
its own exit, brings back at its end, in one read, what its exit tests
would have counted (:meth:`Site.lane_trips`).

**Spans** (always on).  ``with span("correct"):`` marks a stretch of a call
with a name from :data:`SPAN_NAMES`, the span that caused it (the one open
when it opened) and the id of the top-level call it belongs to (the
outermost span's id: one ``fit`` per fit, one ``propagate`` per
propagation).  Each span adds, per name (:data:`spans`), its call, its host
wall, and the reads and nanoseconds blocked in them while it was open,
nested reads included.  A span's wall minus its blocked time is what the
host spent dispatching.

**Records** (on demand).  Inside :func:`recording`, every span that closes
is also kept as a :class:`Record` in the list it hands out, with its start
and end on the ``time.time_ns()`` clock, the clock of ``torch.profiler``'s
events: an idle gap of a profiler trace lies under the innermost span open
at that time.  Nothing is written out.

**Counts** (always on).  Events that are neither a read nor a span:
:data:`escalation` counts the flushes of ``fit_lsq_stream_escalating``, the
rows they hand to the richer stages and those of them a richer stage
recovers; :data:`lsq_step` the correction's two-body Newton steps
(:meth:`Counts.add`).

Counters are plain ints: read one twice and take the difference
(:func:`counters` gives them all).  They are attributes by name, so a
reader can name one as a path, ``sites.dop853.trips`` or
``spans.fit_prepare.wall_ns`` (a span's name with ``_`` for ``.``).  The
worker threads of a device split add to the same counters, under one lock,
and their spans have the span open where the split started as parent
(:func:`outfit_tpu_torch.parallel.sharding.map_devices` runs each worker in
a copy of the caller's context); blocked time is summed over the threads.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import threading
import time
from types import SimpleNamespace
from typing import NamedTuple, Optional

#: the spans the program opens, outermost first: ``escalate`` (a flush of
#: ``fit_lsq_stream_escalating``: the held datasets' failures refitted by
#: the richer stages and patched in), ``fit`` (``_fit_lsq``),
#: ``fit.prepare`` (dataset preparation, the padded layout, the device
#: bases' upload, the seeds' screen), ``observer_cache``
#: (``ObserverCache.build``), ``iod`` (``_IodBatch.fit``),
#: ``iod.fg_correction`` (``gauss._fg_correction``), ``iod.scoring``
#: (``scoring.rms_orbit_error``: the RMS scoring of the candidates and of
#: the polished winners), ``correct`` (``lsq.api._correct``, one per device
#: chunk), ``fit.assemble`` (``_add_results``, ``_as_table``),
#: ``propagate`` (``propagate_nbody``), ``dop853`` (``dop853_integrate``)
SPAN_NAMES = (
    "escalate", "fit", "fit.prepare", "observer_cache", "iod", "iod.fg_correction", "iod.scoring", "correct",
    "fit.assemble", "propagate", "dop853",
)

#: the places the fit and propagation paths read the device: the loops'
#: exit tests (lanes counted), then plain reads and copy-backs
SITE_NAMES = (
    "lsq_prewarm",  # lsq/loop.py: mixed-precision pre-warm loop
    "lsq_newton",  # lsq/loop.py: Newton loop
    "lsq_outlier",  # lsq/loop.py: does any lane need the outlier step
    "lsq_passes",  # lsq/loop.py: outlier-rejection passes
    "iod_aberth",  # iod/roots.py: Aberth root iterations
    "iod_fg",  # iod/gauss.py: f-g correction loop (on a card, the kernel's summary)
    "kepler_newton",  # kepler/universal.py: universal Kepler Newton loop
    "twobody_kepler",  # elements/twobody.py: generalized Kepler loop
    "dop853",  # propagator/dop853.py: integration loop
    "kepler_fallback",  # kepler/universal.py: does any lane need the bracketing
    "stumpff_kmax",  # kepler/stumpff.py: the halving bound of a Stumpff evaluation
    "iod_enumerate",  # iod/api.py: the triplet counts copied back
    "iod_copyback",  # iod/api.py: a chunk's IOD results copied back
    "lsq_copyback",  # lsq/api.py: a chunk's correction results copied back
)

_lock = threading.Lock()
_ids = itertools.count(1)
#: the innermost open span of this context
_open: contextvars.ContextVar[Optional["span"]] = contextvars.ContextVar("outfit_tpu_torch.trace.span", default=None)
_records: Optional[list] = None


def _blocked(ns, site=None, trips=0, live=0, lanes=0):
    """Add one read of ``ns`` nanoseconds to ``site`` and to every open span,
    and ``trips``, ``live`` and ``lanes`` to ``site``."""
    with _lock:
        if site is not None:
            site.reads += 1
            site.blocked_ns += ns
            site.trips += trips
            site.live += live
            site.lanes += lanes
        s = _open.get()
        while s is not None:
            s.reads += 1
            s.blocked_ns += ns
            s = s.parent


class Site:
    """A place where the program reads the device.  Counters: ``reads``,
    ``blocked_ns`` (the thread's wait in them), and at a loop's exit test
    ``trips`` (reads that found a live lane), ``live`` and ``lanes`` (live
    lanes and all lanes, summed over those trips)."""

    __slots__ = ("name", "reads", "blocked_ns", "trips", "live", "lanes")

    def __init__(self, name):
        self.name = name
        self.reads = self.blocked_ns = self.trips = self.live = self.lanes = 0

    def live_lanes(self, mask) -> int:
        """A loop's exit test: the number of lanes set in the boolean
        ``mask`` (0: the loop ends), in one read."""
        n = mask.sum()
        t = time.perf_counter_ns()
        n = int(n)
        _blocked(time.perf_counter_ns() - t, self, int(n > 0), n, mask.numel() if n else 0)
        return n

    def tolist(self, x, lanes=0) -> list:
        """``x.tolist()``; with ``lanes``, ``x[0]`` is a loop's live-lane
        count out of ``lanes``."""
        t = time.perf_counter_ns()
        out = x.tolist()
        live = out[0] if lanes else 0
        _blocked(time.perf_counter_ns() - t, self, int(live > 0), live, lanes if live else 0)
        return out

    def lane_trips(self, x, lanes) -> list:
        """The end of a loop that ran on the device, each of ``lanes`` lanes
        to its own exit: ``x`` holds [the most trips a lane was live at,
        the sum of those trips], read in one read.  Adds what the exit
        tests of the same loop run batched would have added: the most
        trips, the lanes live at them (the sum) and the lanes in all (the
        most trips times ``lanes``)."""
        t = time.perf_counter_ns()
        out = x.tolist()
        trips, live = out
        _blocked(time.perf_counter_ns() - t, self, trips, live, trips * lanes)
        return out

    def item(self, x):
        """``x.item()``."""
        t = time.perf_counter_ns()
        out = x.item()
        _blocked(time.perf_counter_ns() - t, self)
        return out

    def cpu(self, x):
        """``x.cpu()``: one copy back to the host."""
        t = time.perf_counter_ns()
        out = x.cpu()
        _blocked(time.perf_counter_ns() - t, self)
        return out


class SpanStats:
    """Per-name totals of a span: ``calls``, ``wall_ns`` (host wall),
    ``reads`` and ``blocked_ns`` (device reads while it was open, nested
    ones included)."""

    __slots__ = ("name", "calls", "wall_ns", "reads", "blocked_ns")

    def __init__(self, name):
        self.name = name
        self.calls = self.wall_ns = self.reads = self.blocked_ns = 0


class Counts:
    """Named event counts of one part of the program, plain ints."""

    def __init__(self, name, fields):
        self.name, self.fields = name, fields
        for f in fields:
            setattr(self, f, 0)

    def add(self, **deltas):
        """Add ``deltas`` (field -> int) under the counters' lock."""
        with _lock:
            for f, v in deltas.items():
                setattr(self, f, getattr(self, f) + int(v))


#: ``fit_lsq_stream_escalating``'s flushes: ``flushes`` (flushes of held
#: datasets), ``rows`` (rows handed to the richer stages), ``recovered``
#: (of those, rows that the retry predicate no longer retries after the
#: last richer stage they ran: with the default predicate, converged
#: through the correction)
escalation = Counts("escalation", ("flushes", "rows", "recovered"))
#: the differential correction's Newton steps: ``two_body`` (two-body steps
#: on any device; on a card each is one launch of ``lsq/step_cuda.py``)
lsq_step = Counts("lsq_step", ("two_body",))

#: the counters of each site, by name: ``sites.dop853``
sites = SimpleNamespace(**{n: Site(n) for n in SITE_NAMES})
#: the totals of each span, by name with ``_`` for ``.``: ``spans.fit_prepare``
spans = SimpleNamespace(**{n.replace(".", "_"): SpanStats(n) for n in SPAN_NAMES})
_STATS = {n: getattr(spans, n.replace(".", "_")) for n in SPAN_NAMES}


class Record(NamedTuple):
    """One closed span: ``parent`` is None at the top of a call, ``call``
    the top span's ``id``; ``start_ns`` / ``end_ns`` on ``time.time_ns()``."""

    name: str
    id: int
    parent: Optional[int]
    call: int
    thread: int
    start_ns: int
    end_ns: int


class span:
    """``with span(name):`` one stretch of a call; ``name`` from
    :data:`SPAN_NAMES`."""

    __slots__ = ("stats", "id", "parent", "call", "reads", "blocked_ns", "start_ns", "_token")

    def __init__(self, name):
        self.stats = _STATS[name]

    def __enter__(self):
        self.parent = _open.get()
        self.id = next(_ids)
        self.call = self.id if self.parent is None else self.parent.call
        self.reads = self.blocked_ns = 0
        self._token = _open.set(self)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        _open.reset(self._token)
        st = self.stats
        with _lock:
            st.calls += 1
            st.wall_ns += end - self.start_ns
            st.reads += self.reads
            st.blocked_ns += self.blocked_ns
        kept = _records
        if kept is not None:
            parent = None if self.parent is None else self.parent.id
            kept.append(Record(st.name, self.id, parent, self.call, threading.get_ident(), self.start_ns, end))
        return False


@contextlib.contextmanager
def recording():
    """``with recording() as records:`` keeps each span that closes inside
    as a :class:`Record` in ``records``, in the order they close.  A
    recording inside another keeps its spans to itself."""
    global _records
    kept, outer = [], _records
    _records = kept
    try:
        yield kept
    finally:
        _records = outer


def counters() -> dict:
    """Every counter now: ``{"sites": {name: {...}}, "spans": {name: {...}},
    "counts": {name: {...}}}``."""
    with _lock:
        return {
            "sites": {s.name: {k: getattr(s, k) for k in Site.__slots__[1:]} for s in vars(sites).values()},
            "spans": {s.name: {k: getattr(s, k) for k in SpanStats.__slots__[1:]} for s in _STATS.values()},
            "counts": {c.name: {k: getattr(c, k) for k in c.fields} for c in (escalation, lsq_step)},
        }
