"""CUDA kernel for Chebyshev table evaluation: build, load and launch.

Replaces the Pallas TPU kernel ``outfit_tpu/ephem/pallas_kernel.py``
(``_kernel`` launched through ``pl.pallas_call`` in ``_run``).  The source is
``outfit_tpu_torch/csrc/chebyshev.cu`` (launcher) and ``chebyshev.cuh``
(kernel); the note at the top of the ``.cuh`` says what bounds it and how
its design answers that.  ``nvcc`` compiles it for ``sm_90a`` into a shared
library with a plain C interface at first use, into ``_build/<hash of the
sources>/`` beside this package's sources; ``ctypes`` loads it.

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
import hashlib
import os
import shutil
import subprocess
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_SOURCES = ("chebyshev.cu", "chebyshev.cuh")
_BUILD_ROOT = os.path.join(_PKG, "_build")
#: ``-fmad=false``: no multiply-add contraction, so the recurrence rounds
#: as the plain version's elementwise products do and only the order of the
#: final sum differs from it
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the kernel keeps a row's coefficients in a runtime loop; the launcher
#: refuses more than this many per channel
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


def _source_hash() -> str:
    h = hashlib.sha256()
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set $NVCC or $CUDA_HOME, or put nvcc on PATH")


def build() -> tuple:
    """Compile the library if this source hash has not been built yet.

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and spill report when a build ran, else is empty."""
    with _lock:
        return _build()


def _build() -> tuple:
    out_dir = os.path.join(_BUILD_ROOT, _source_hash())
    lib_path = os.path.join(out_dir, "libchebyshev.so")
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, "chebyshev.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr


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
