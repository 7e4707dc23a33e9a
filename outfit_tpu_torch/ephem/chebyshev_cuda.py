"""CUDA kernel for Chebyshev table evaluation: build, load and launch.

Replaces the Pallas TPU kernel ``outfit_tpu/ephem/pallas_kernel.py``
(``_kernel`` launched through ``pl.pallas_call`` in ``_run``).  The source is
``outfit_tpu_torch/csrc/chebyshev.cu`` (launcher) and ``chebyshev.cuh``
(kernel); the note at the top of the ``.cuh`` says what bounds it and how
its design answers that.  ``nvcc`` compiles it for ``sm_90a`` into a shared
library with a plain C interface at first use, into ``_build/<hash of the
sources>/`` beside this package's sources (``utils/cuda_build.py``); ``ctypes``
loads it.

The two call sites of the fitting path each have their own channel count:

* ``site="body"``: 3 channels with the derivative (body position and
  velocity, :func:`outfit_tpu_torch.ephem.chebyshev.interpolate_body`),
* ``site="frame"``: 10 channels without (the observer frame table,
  :func:`outfit_tpu_torch.observer.cache._frame_interp`).

:data:`launches` counts the launches of each, and nothing else.  The build,
the load and the count are safe from several threads (a caller may fit
from several).
"""

from __future__ import annotations

import ctypes
import threading

import torch

from outfit_tpu_torch.utils import cuda_build

_SOURCES = ("chebyshev.cu", "chebyshev.cuh")
_BUILD_ROOT = cuda_build.BUILD_ROOT

#: the launcher holds one instantiation of the kernel for each coefficient
#: count per channel from 2 to this, and refuses the rest
MAX_COEFF = 32

#: channel count and derivative flag of each call site
_SITES = {"body": (3, True), "frame": (10, False)}

#: launches of the kernel per call site, counted where it launches
launches = {"body": 0, "frame": 0}

_lib = None
#: guards the build, the load and the launch counts
_lock = threading.RLock()


def reset_launch_counts() -> None:
    with _lock:
        for k in launches:
            launches[k] = 0


def build() -> tuple:
    """Compile the library if this source hash has not been built yet
    (:func:`outfit_tpu_torch.utils.cuda_build.build`).

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and spill report when a build ran, else is empty."""
    with _lock:
        return cuda_build.build(_SOURCES, "libchebyshev.so", _BUILD_ROOT)


def _load():
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(path)
            fn = lib.outfit_chebyshev_f64
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double,
                ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def evaluate(coeffs: torch.Tensor, mjd: torch.Tensor, t0: float, gran: float, site: str):
    """Launch the kernel: ``coeffs`` (G, CH, C) and ``mjd`` (N,), both
    contiguous float64 on one CUDA device.  Returns ``(values (N, CH),
    derivative (N, CH) or None)``, allocated here; the launch goes on the
    current stream and does not synchronise."""
    ch, deriv = _SITES[site]
    if mjd.device.type != "cuda" or coeffs.device != mjd.device:
        raise ValueError(
            f"chebyshev kernel needs coeffs and mjd on one CUDA device, got "
            f"{coeffs.device} and {mjd.device}"
        )
    if coeffs.dtype != torch.float64 or mjd.dtype != torch.float64:
        raise TypeError(f"chebyshev kernel takes float64, got {coeffs.dtype}, {mjd.dtype}")
    if coeffs.dim() != 3 or coeffs.shape[1] != ch or mjd.dim() != 1:
        raise ValueError(
            f"site {site!r} takes coeffs (G, {ch}, C) and mjd (N,), got "
            f"{tuple(coeffs.shape)} and {tuple(mjd.shape)}"
        )
    n_gran, _, n_coeff = coeffs.shape
    if not 2 <= n_coeff <= MAX_COEFF or n_gran < 1:
        raise ValueError(f"chebyshev kernel takes 2..{MAX_COEFF} coefficients, G >= 1")
    if not (coeffs.is_contiguous() and mjd.is_contiguous()):
        raise ValueError("chebyshev kernel takes contiguous tensors")
    if (ch * n_coeff) % 2 == 0 and coeffs.data_ptr() % 16:
        raise ValueError("chebyshev kernel copies rows of a multiple of 16 bytes in 16-byte "
                         "pieces: coeffs must be 16-byte aligned")
    n = mjd.shape[0]
    out = torch.empty((n, ch), dtype=torch.float64, device=mjd.device)
    dout = torch.empty((n, ch), dtype=torch.float64, device=mjd.device) if deriv else None
    if n == 0:
        return out, dout
    lib = _load()
    with torch.cuda.device(mjd.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.outfit_chebyshev_f64(
            coeffs.data_ptr(), n_gran, ch, n_coeff, mjd.data_ptr(), n,
            float(t0), float(gran), out.data_ptr(),
            None if dout is None else dout.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"chebyshev kernel launch failed: CUDA error {err}")
    with _lock:
        launches[site] += 1
    return out, dout
