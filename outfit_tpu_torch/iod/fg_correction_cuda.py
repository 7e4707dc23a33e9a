"""CUDA kernel for the IOD's f-g correction: build, load and launch.

Replaces no Pallas kernel: the JAX package runs this refinement as an XLA
``while_loop`` (``outfit_tpu/iod/gauss.py:_fg_correction``).  Its PyTorch
form, :func:`outfit_tpu_torch.iod.gauss._fg_correction_plain`, is a Python
loop of batched tensor operations that reads the device at every outer and
every nested Kepler Newton trip; on a card the host's dispatch of that loop
set the pace.  The kernel runs the whole refinement in one launch, one
thread per candidate to its own exit (``outfit_tpu_torch/csrc/
fg_correction.cu`` and ``.cuh``; the note at the top of the ``.cuh`` says
what bounds it and how its design answers that).  It is built as the K1
kernel is (``utils/cuda_build.py``), into its own library.

:data:`launches` counts the launches of each working type, and nothing
else.  The build, the load and the count are safe from several threads (a
device split fits from several).
"""

from __future__ import annotations

import ctypes
import math
import threading

import torch

from outfit_tpu_torch.constants import GAUSS_GRAV_SQUARED, VLIGHT_AU
from outfit_tpu_torch.utils import cuda_build

_SOURCES = ("fg_correction.cu", "fg_correction.cuh")
_BUILD_ROOT = cuda_build.BUILD_ROOT
#: the absolute angular-momentum guard of ``velocity_correction``, in any
#: working type
_H_MIN = 1e6 * torch.finfo(torch.float64).eps

#: launches of the kernel per working type, counted where it launches
launches = {"float32": 0, "float64": 0}

_lib = None
#: guards the build, the load and the launch counts
_lock = threading.RLock()


class _Params(ctypes.Structure):
    _fields_ = [
        ("max_it", ctypes.c_int), ("max_newton", ctypes.c_int), ("conv", ctypes.c_double),
        ("done_eps", ctypes.c_double), ("peri_max", ctypes.c_double), ("ecc_max", ctypes.c_double),
        ("min_rho2", ctypes.c_double), ("mu", ctypes.c_double), ("sqrt_mu", ctypes.c_double),
        ("vlight", ctypes.c_double), ("h_min", ctypes.c_double),
    ]


#: the tensors of a call in ``FgCall``'s order (fg_correction.cu)
_POINTERS = (
    "obs_pos", "s_inv", "u", "time", "dt01", "dt21", "pos", "vel", "epoch", "chi1", "chi2", "alive",
    "pos_out", "vel_out", "epoch_out", "chi1_out", "chi2_out", "alive_out", "committed_out", "trips_out",
    "summary",
)


class _Call(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _POINTERS] + [
        ("n", ctypes.c_longlong), ("per", ctypes.c_longlong), ("params", _Params),
    ]


def reset_launch_counts() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def build() -> tuple:
    """Compile the library if this source hash has not been built yet.

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and spill report when a build ran, else is empty."""
    with _lock:
        return cuda_build.build(_SOURCES, "libfg_correction.so", _BUILD_ROOT)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            lib.outfit_fg_correction.argtypes = [ctypes.POINTER(_Call), ctypes.c_int, ctypes.c_void_p]
            lib.outfit_fg_correction.restype = ctypes.c_int
            _lib = lib
    return _lib


def correct(obs_pos, s_inv, u, time, dt01, dt21, pos, vel, epoch, chi1, chi2, alive, *,
            max_it: int, max_newton: int, conv: float, done_eps: float, peri_max: float, ecc_max: float,
            min_rho2: float):
    """Launch the kernel over N candidates of M triplets, ``per = N // M``
    consecutive candidates a triplet.

    Per triplet: ``obs_pos``, ``s_inv``, ``u`` (M, 3, 3) in the working
    type (float32 or float64), ``time`` (M, 3), ``dt01``, ``dt21`` (M,)
    float64.  Per candidate: ``pos`` (N, 3, 3), ``vel`` (N, 3), ``chi1``,
    ``chi2`` (N,) in the working type, ``epoch`` (N,) float64, ``alive``
    (N,) bool.  Every tensor contiguous on one CUDA device.  Returns
    ``(pos, vel, epoch, chi1, chi2, alive, committed, trips, summary)``,
    allocated here: the refined candidates, each one's count of outer trips
    at whose start it was alive and not done (int32), and ``summary``
    (int64: the most such trips, their sum).  The launch goes on the
    device's current stream and does not synchronise."""
    dev = pos.device
    work = pos.dtype
    tensors = dict(obs_pos=obs_pos, s_inv=s_inv, u=u, time=time, dt01=dt01, dt21=dt21, pos=pos, vel=vel,
                   epoch=epoch, chi1=chi1, chi2=chi2, alive=alive)
    if dev.type != "cuda" or any(t.device != dev for t in tensors.values()):
        raise ValueError("f-g correction kernel needs every tensor on one CUDA device, got "
                         + ", ".join(f"{k} on {t.device}" for k, t in tensors.items()))
    want = dict.fromkeys(("obs_pos", "s_inv", "u", "pos", "vel", "chi1", "chi2"), work)
    want.update(dict.fromkeys(("time", "dt01", "dt21", "epoch"), torch.float64), alive=torch.bool)
    if work not in (torch.float32, torch.float64) or any(tensors[k].dtype != d for k, d in want.items()):
        raise TypeError("f-g correction kernel takes a float32 or float64 working type, float64 epochs "
                        "and a bool mask, got " + ", ".join(f"{k} {t.dtype}" for k, t in tensors.items()))
    n = pos.shape[0]
    m = obs_pos.shape[0]
    shapes = dict(obs_pos=(m, 3, 3), s_inv=(m, 3, 3), u=(m, 3, 3), time=(m, 3), dt01=(m,), dt21=(m,),
                  pos=(n, 3, 3), vel=(n, 3), epoch=(n,), chi1=(n,), chi2=(n,), alive=(n,))
    if any(tuple(tensors[k].shape) != s for k, s in shapes.items()) or (n and (m == 0 or n % m)):
        raise ValueError("f-g correction kernel takes M triplets and a multiple N of M candidates, got "
                         + ", ".join(f"{k} {tuple(t.shape)}" for k, t in tensors.items()))
    if not all(t.is_contiguous() for t in tensors.values()):
        raise ValueError("f-g correction kernel takes contiguous tensors")

    out = dict(
        pos_out=torch.empty_like(pos), vel_out=torch.empty_like(vel), epoch_out=torch.empty_like(epoch),
        chi1_out=torch.empty_like(chi1), chi2_out=torch.empty_like(chi2), alive_out=torch.empty_like(alive),
        committed_out=torch.empty_like(alive), trips_out=torch.empty(n, dtype=torch.int32, device=dev),
        summary=torch.zeros(2, dtype=torch.int64, device=dev),
    )
    if n:
        params = _Params(int(max_it), int(max_newton), float(conv), float(done_eps), float(peri_max),
                         float(ecc_max), float(min_rho2), GAUSS_GRAV_SQUARED, math.sqrt(GAUSS_GRAV_SQUARED),
                         VLIGHT_AU, _H_MIN)
        call = _Call(*(t.data_ptr() for t in (*tensors.values(), *out.values())), n, n // m, params)
        lib = _load()
        with torch.cuda.device(dev):
            err = lib.outfit_fg_correction(ctypes.byref(call), int(work == torch.float64),
                                           torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"f-g correction kernel launch failed: CUDA error {err}")
        with _lock:
            launches[str(work).removeprefix("torch.")] += 1
    return tuple(out.values())
