# Source: outfit_tpu/parallel/sharding.py (a device tuple in place of a jax Mesh).
"""Device lists and batch-axis splitting helpers.

A mesh here is a tuple of ``torch.device``; a name may repeat (one card
named twice runs two chunks on it).  :func:`shard_batch` gives each device
a contiguous chunk of the leading axis, the chunks' lengths differing by at
most one (the first ones longer); nothing is padded, since nothing here
needs even shards.  The fit entry points use :func:`fit_devices` (the
devices a ``device=`` argument names), :func:`chunk_bounds` (each device's
rows, cut where every row keeps the reduction order it has on one device)
and :func:`map_devices` (one worker thread per device).
"""

from __future__ import annotations

import contextlib
import contextvars
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch


def data_mesh(devices: Optional[Sequence] = None) -> tuple:
    """The devices as a tuple of ``torch.device``; default every visible
    CUDA card."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    return tuple(torch.device(d) for d in devices)


def pad_to_multiple(n: int, k: int) -> int:
    """Smallest multiple of k that is >= n."""
    return ((n + k - 1) // k) * k


def auto_mesh() -> Optional[tuple]:
    """Every visible CUDA card; None on fewer than two."""
    if torch.cuda.device_count() < 2:
        return None
    return data_mesh()


def resolve_mesh(mesh):
    """Normalize a user ``mesh`` argument: "auto" -> auto_mesh(), None/False
    -> None (single-device), a device list -> a tuple of devices."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', None, or a Mesh; got {mesh!r}")
        return auto_mesh()
    if mesh is None or mesh is False:
        return None
    return data_mesh(mesh)


def split_bounds(n: int, k: int) -> list:
    """``[start, end)`` of ``k`` contiguous chunks of ``range(n)``, their
    lengths differing by at most one, the first ones longer."""
    q, r = divmod(n, k)
    ends = np.cumsum([q + 1] * r + [q] * (k - r)).tolist()
    return list(zip([0] + ends[:-1], ends))


#: a fit's chunks start a multiple of this many rows into each batch tensor
#: of one device's fit and hold at least this many rows: a CUDA reduction
#: along a row reads it in aligned vectors from its address and picks its
#: threads by the row count below 16 rows, so only then does every row sum
#: in the order it sums on one device
CHUNK_ROWS = 16


def chunk_bounds(spans, k: int) -> list:
    """``[start, end)`` of ``k`` contiguous chunks of the rows covered by
    ``spans``, the consecutive ``[start, end)`` batches one device would fit
    (each as one tensor).  A boundary is a span's edge or lies a multiple of
    :data:`CHUNK_ROWS` into a span with at least that many rows after it,
    the nearest such point to an even split; a chunk that cannot be filled
    is empty."""
    n = spans[-1][1] if spans else 0
    cuts = sorted({n}.union(*(range(s, e - CHUNK_ROWS + 1, CHUNK_ROWS) for s, e in spans)))
    bounds = [0]
    for i in range(1, k):
        bounds.append(min((c for c in cuts if c >= bounds[-1]), key=lambda c: abs(c - i * n / k)))
    return list(zip(bounds, bounds[1:] + [n]))


def _tree_map(fn, x):
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    return None if x is None else fn(x)


def _place(a, device):
    if isinstance(a, torch.Tensor):
        return a.to(device)
    if isinstance(a, np.ndarray):
        return torch.as_tensor(a, device=device)
    return a


def replicate(mesh, x) -> tuple:
    """One copy of a tensor (or nested tuples, NamedTuples, lists and dicts
    of them) per device of ``mesh``; numpy arrays become tensors."""
    return tuple(_tree_map(lambda a: _place(a, d), x) for d in mesh)


def shard_batch(mesh, x) -> tuple:
    """Per device of ``mesh``, its contiguous chunk of the leading axis of
    every tensor or numpy array in ``x`` (nested as for
    :func:`replicate`), placed on that device."""

    def chunk(a, i, d):
        if not isinstance(a, (torch.Tensor, np.ndarray)) or a.ndim == 0:
            raise TypeError(f"shard_batch splits arrays along a leading axis, got {type(a).__name__}")
        s, e = split_bounds(a.shape[0], len(mesh))[i]
        return _place(a[s:e], d)

    return tuple(_tree_map(lambda a: chunk(a, i, d), x) for i, d in enumerate(mesh))


def fit_devices(device) -> tuple:
    """The devices a fit entry point's ``device`` names: one device; a list
    (names may repeat); ``"auto"``, every visible CUDA card (an error where
    there is none); None, ``"auto"`` where a card is present, else the
    CPU."""
    if device is None:
        device = "auto" if torch.cuda.is_available() else "cpu"
    if isinstance(device, str) and device == "auto":
        if not torch.cuda.is_available():
            raise RuntimeError("device='auto' needs a CUDA device, and none is visible")
        return data_mesh()
    if isinstance(device, (list, tuple)):
        if not device:
            raise ValueError("device: an empty device list")
        return data_mesh(device)
    return (torch.device(device),)


def _on_device(fn, device, arg):
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        return fn(device, arg)


def map_devices(devices, fn, args) -> list:
    """``[fn(device, arg) for device, arg in zip(devices, args)]``: inline
    for one device; else one worker thread per device, with that device
    current, in a copy of the caller's context (so the
    :mod:`outfit_tpu_torch.trace` span open here is the parent of the
    worker's spans).  Every worker runs to its end; the first error raised
    in one (in device order) is raised here.  Threads, not processes: the
    chunks share the dataset, the observer cache and the ephemeris without
    a copy, and PyTorch releases the interpreter lock inside its operators
    and while it waits for a device."""
    if len(devices) == 1:
        return [fn(devices[0], args[0])]
    with ThreadPoolExecutor(max_workers=len(devices)) as pool:
        futures = [pool.submit(contextvars.copy_context().run, _on_device, fn, d, a) for d, a in zip(devices, args)]
        return [f.result() for f in futures]
