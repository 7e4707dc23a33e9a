"""CUDA kernel for the two-body Newton step of the differential correction:
build, load and launch.

Replaces no Pallas kernel: the JAX package runs the step as XLA
(``outfit_tpu/lsq/iteration.py:single_iteration``).  Its PyTorch form,
:func:`outfit_tpu_torch.lsq.iteration._single_iteration_plain`, is some
1,800-1,950 small batched tensor operations a step, with one device read a
trip of the Kepler solve; on a card the host's dispatch of those
operations set the pace of every fit.  The kernel runs the whole step in
one launch, one warp per trajectory (``outfit_tpu_torch/csrc/lsq_step.cu``
and ``.cuh``; the note at the top of the ``.cuh`` says what bounds it and
how its design answers that).  It is built as the other kernels are
(``utils/cuda_build.py``), into its own library.

:data:`launches` counts the launches of each working type (the
propagation's, then the Jacobians'), and nothing else.  The build, the
load and the count are safe from several threads (a device split fits
from several).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from outfit_tpu_torch.constants import DPI, GAUSS_GRAV_SQUARED, ROT_ECLMJ2000_TO_EQUMJ2000, VLIGHT_AU
from outfit_tpu_torch.elements import twobody
from outfit_tpu_torch.utils import cuda_build

_SOURCES = ("lsq_step.cu", "lsq_step.cuh")
_BUILD_ROOT = cuda_build.BUILD_ROOT
_F32, _F64 = torch.float32, torch.float64
#: the kernel's working types, (propagation, Jacobians) -> its ``kind``
KINDS = {(_F32, _F32): 0, (_F64, _F32): 1, (_F64, _F64): 2}

#: launches of the kernel per working type, counted where it launches
launches = {"float32": 0, "float64_float32": 0, "float64": 0}
_NAMES = {0: "float32", 1: "float64_float32", 2: "float64"}

_lib = None
#: guards the build, the load and the launch counts
_lock = threading.RLock()


class _Params(ctypes.Structure):
    _fields_ = [
        ("mu", ctypes.c_double), ("vlight", ctypes.c_double), ("dpi", ctypes.c_double), ("pi", ctypes.c_double),
        ("circ", ctypes.c_double), ("res_tol", ctypes.c_double), ("rot", ctypes.c_double * 9),
        ("sin_c", ctypes.c_double * 8), ("cos_c", ctypes.c_double * 9), ("max_iter", ctypes.c_int),
    ]


#: the inputs of a call in ``StepCall``'s order (lsq_step.cu), then the outputs
INPUTS = (
    "elements", "epoch", "selection", "mjd", "ra", "dec", "sigma_ra", "sigma_dec", "helio_pos", "valid",
    "bias_ra", "bias_dec", "warm_f", "warm_s", "warm_c", "free",
)
OUTPUTS = (
    "corrected", "corr_norm", "rms", "normal", "cov", "inv_ok", "m", "res_ra", "res_dec", "d_ra", "d_dec",
    "active", "kepler",
)
#: inputs that may be None (no bias; a cold Kepler start)
OPTIONAL = ("bias_ra", "bias_dec", "warm_f", "warm_s", "warm_c")


class _Call(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in INPUTS + OUTPUTS] + [
        ("warm_st", (ctypes.c_longlong * 2) * 3), ("T", ctypes.c_longlong), ("N", ctypes.c_longlong),
        ("params", _Params),
    ]


#: the plain path's constants, as the Python numbers it uses
_PARAMS = _Params(
    GAUSS_GRAV_SQUARED, VLIGHT_AU, DPI, math.pi, 100.0 * twobody._EPS, twobody.RES_TOL,
    (ctypes.c_double * 9)(*(float(v) for v in ROT_ECLMJ2000_TO_EQUMJ2000.reshape(-1))),
    (ctypes.c_double * 8)(*twobody._SIN_C), (ctypes.c_double * 9)(*twobody._COS_C), twobody.MAX_ITER,
)


def reset_launch_counts() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def build() -> tuple:
    """Compile the library if this source hash has not been built yet.

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and spill report when a build ran, else is empty."""
    with _lock:
        return cuda_build.build(_SOURCES, "liblsq_step.so", _BUILD_ROOT)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            lib.outfit_lsq_step.argtypes = [ctypes.POINTER(_Call), ctypes.c_int, ctypes.c_void_p]
            lib.outfit_lsq_step.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(t: dict, jacobian_dtype):
    """Raise for what the kernel does not take; returns (kind, T, N)."""
    given = {k: v for k, v in t.items() if v is not None}
    missing = [k for k in INPUTS if k not in OPTIONAL and t.get(k) is None]
    if missing:
        raise ValueError(f"two-body step kernel needs {', '.join(missing)}")
    dev = t["elements"].device
    if dev.type != "cuda" or any(v.device != dev for v in given.values()):
        raise ValueError("two-body step kernel needs every tensor on one CUDA device, got "
                         + ", ".join(f"{k} on {v.device}" for k, v in given.items()))
    work = t["elements"].dtype
    kind = KINDS.get((work, jacobian_dtype))
    want = dict.fromkeys(("elements", "ra", "dec", "sigma_ra", "sigma_dec", "helio_pos", *OPTIONAL), work)
    want.update(epoch=_F64, mjd=_F64, selection=torch.int32, valid=torch.bool, free=torch.bool)
    if kind is None or any(v.dtype != want[k] for k, v in given.items()):
        raise TypeError(
            "two-body step kernel takes float32 / float32, float64 / float32 or float64 / float64 working types "
            "(propagation / Jacobians), float64 epochs and MJDs, int32 selections and bool masks, got "
            + ", ".join(f"{k} {v.dtype}" for k, v in given.items()) + f", Jacobians {jacobian_dtype}")
    T, N = t["mjd"].shape if t["mjd"].dim() == 2 else (-1, -1)
    shapes = dict(elements=(T, 6), epoch=(T,), free=(6,), helio_pos=(T, N, 3))
    if (T < 0 or any(tuple(v.shape) != shapes.get(k, (T, N)) for k, v in given.items())
            or sum(t[k] is None for k in ("bias_ra", "bias_dec")) == 1
            or sum(t[k] is None for k in ("warm_f", "warm_s", "warm_c")) not in (0, 3)):
        raise ValueError("two-body step kernel takes (T, 6) elements, (T,) epochs, (T, N) observations, "
                         "(T, N, 3) observer positions, both biases or none, all three warm starts or none, got "
                         + ", ".join(f"{k} {tuple(v.shape)}" for k, v in given.items()))
    if not all(v.is_contiguous() for k, v in given.items() if not k.startswith("warm_")):
        raise ValueError("two-body step kernel takes contiguous tensors (the warm starts at any strides)")
    return kind, T, N


def step(elements, epoch, selection, mjd, ra, dec, sigma_ra, sigma_dec, helio_pos, valid, bias_ra, bias_dec,
         warm_f, warm_s, warm_c, free, *, jacobian_dtype):
    """Launch the kernel over T trajectories of N padded observations.

    ``elements`` (T, 6) in the working type (float32 or float64), ``epoch``
    (T,) float64, ``selection`` (T, N) int32, ``mjd`` (T, N) float64,
    ``ra``, ``dec``, ``sigma_ra``, ``sigma_dec`` (T, N) and ``helio_pos``
    (T, N, 3) in the working type, ``valid`` (T, N) bool, ``bias_ra``,
    ``bias_dec`` (T, N) or None, the warm start ``warm_f``, ``warm_s``,
    ``warm_c`` (T, N) at any strides or None (a cold start), ``free`` (6,)
    bool, all on one CUDA device; ``jacobian_dtype`` float32 below a
    float64 working type (mixed precision), else the working type.  Returns
    the step's outputs in :class:`~outfit_tpu_torch.lsq.iteration.IterationResult`'s
    order, allocated here.  The launch goes on the device's current stream
    and does not synchronise."""
    t = dict(zip(INPUTS, (elements, epoch, selection, mjd, ra, dec, sigma_ra, sigma_dec, helio_pos, valid,
                          bias_ra, bias_dec, warm_f, warm_s, warm_c, free)))
    kind, T, N = _check(t, jacobian_dtype)
    dev, work = elements.device, elements.dtype
    e = dict(dtype=work, device=dev)
    out = dict(
        corrected=torch.empty((T, 6), **e), corr_norm=torch.empty(T, **e), rms=torch.empty(T, **e),
        normal=torch.empty((T, 6, 6), **e), cov=torch.empty((T, 6, 6), **e),
        inv_ok=torch.empty(T, dtype=torch.bool, device=dev), m=torch.empty(T, dtype=torch.int32, device=dev),
        res_ra=torch.empty((T, N), **e), res_dec=torch.empty((T, N), **e), d_ra=torch.empty((T, N, 6), **e),
        d_dec=torch.empty((T, N, 6), **e), active=torch.empty((T, N), dtype=torch.bool, device=dev),
        kepler=torch.empty((T, N, 3), **e),
    )
    if T:
        ptr = [None if v is None else v.data_ptr() for v in t.values()]
        warm_st = ((ctypes.c_longlong * 2) * 3)(*(
            (ctypes.c_longlong * 2)(*((0, 0) if w is None else w.stride())) for w in (warm_f, warm_s, warm_c)))
        call = _Call(*ptr, *(v.data_ptr() for v in out.values()), warm_st, T, N, _PARAMS)
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.outfit_lsq_step(ctypes.byref(call), kind, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"two-body step kernel launch failed: CUDA error {err}")
        with _lock:
            launches[_NAMES[kind]] += 1
    return tuple(out.values())
