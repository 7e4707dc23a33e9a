"""Tensor construction helpers shared by the port's modules."""

import math
import threading

import torch
import torch.nn.functional as F


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor.  A tensor keeps its device; anything else
    (Python or numpy scalars and arrays) is placed on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def as_float(x, device=None) -> torch.Tensor:
    """``x`` as a floating-point tensor in its working precision: a floating
    tensor is returned as it is (float32 on the mixed-precision paths);
    anything else becomes float64, a non-tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.is_floating_point() else x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def as_floats(first, *rest):
    """The arguments as floating-point tensors of one working precision (the
    promotion of their dtypes), on the first one's device."""
    first = as_float(first)
    ts = [first] + [as_float(x, first.device) for x in rest]
    dtype = ts[0].dtype
    for t in ts[1:]:
        dtype = torch.promote_types(dtype, t.dtype)
    return [t.to(dtype) for t in ts]


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"`` when a card is
    present, else ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


def input_device(device, *inputs) -> torch.device:
    """Where an entry point computes: ``device`` when the caller names one;
    else the card an input already lies on; else the default of
    :func:`resolve_device`, the card when one is present.  Numbers, numpy
    arrays and CPU tensors (a fit result's elements) do not ask for the
    CPU: ``device="cpu"`` does."""
    if device is None:
        for x in inputs:
            if isinstance(x, torch.Tensor) and x.is_cuda:
                return x.device
    return resolve_device(device)


_CONSTANTS = {}
_CONSTANTS_LOCK = threading.Lock()


def device_constant(array, device, dtype=torch.float64) -> torch.Tensor:
    """The module-level numpy constant ``array`` as a tensor on ``device``,
    uploaded once per (array, device, dtype) and shared: uploading a host
    array on every call is a blocking copy that waits for the card's queue.
    The upload from pageable host memory completes before it returns, so
    callers fitting from other threads or CUDA streams may read the tensor
    at once.
    Callers must not modify the result."""
    key = (id(array), torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        with _CONSTANTS_LOCK:
            t = _CONSTANTS.get(key)
            if t is None:
                t = _CONSTANTS[key] = torch.as_tensor(array, dtype=dtype, device=device)
    return t


#: the CPU pieces of :func:`lanewise`: a multiple of every step of PyTorch's
#: CPU SIMD loops (two vectors: at most 32 float32 lanes under AVX-512),
#: and under its grain size (32,768 elements), so that a piece is one
#: thread's whole range
_LANE_STEP, _LANE_PIECE = 64, 16384


def lanewise(fn, *args):
    """``fn(*args)`` for an elementwise torch function ``fn`` (``atan2``,
    ``atanh``, ``sinh``, ``cosh``, ``pow``, ``hypot``), each element's value
    independent of where it lies in the tensors.  On the CPU PyTorch
    evaluates these over SIMD vectors, and the end of a range (of the
    tensor, and of each thread's share) in scalar code; the two round a few
    percent of inputs an ulp apart, so a trajectory's result would depend
    on its batch and on a device split.  There the broadcast arguments are
    flattened, padded to whole vector steps and taken in single-thread
    pieces, so every element is a vector lane.  On a CUDA device every
    element runs the same code and ``fn`` runs as it is."""
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if tensors[0].device.type != "cpu":
        return fn(*args)
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    n = math.prod(shape)
    if n == 0:
        return fn(*args)
    pad = -n % _LANE_STEP
    flat = [F.pad(a.broadcast_to(shape).reshape(-1), (0, pad)) if isinstance(a, torch.Tensor) else a for a in args]
    out = torch.cat([
        fn(*(f[i:i + _LANE_PIECE] if isinstance(f, torch.Tensor) else f for f in flat))
        for i in range(0, n + pad, _LANE_PIECE)
    ])
    return out[:n].reshape(shape)
