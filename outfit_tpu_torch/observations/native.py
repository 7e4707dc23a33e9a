# Source: outfit_tpu/native/__init__.py (built into _build/<hash>/ as the CUDA kernel is).
"""The native MPC 80-column parser (C, bound with ctypes).

``outfit_tpu_torch/csrc/mpc80.c`` is compiled with the system's ``cc`` at
first use into ``outfit_tpu_torch/_build/<hash of the source>/``, the way
:mod:`outfit_tpu_torch.ephem.chebyshev_cuda` builds its library.  It is host
code: where no compiler exists, :func:`native_available` is False and
``ObsDataset.from_mpc_80_col_files`` uses the Python parser
(:mod:`outfit_tpu_torch.observations.mpc80`), which is the reference
behaviour the native parser is held to field for field.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "csrc", "mpc80.c")
_BUILD_ROOT = os.path.join(_PKG, "_build")
_CC_FLAGS = ("-O2", "-shared", "-fPIC")

_lib = None
_build_failed = False
#: guards the build and the load
_lock = threading.Lock()


def _source_hash() -> str:
    h = hashlib.sha256()
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(_CC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build():
    """Compile (once per source hash) and load the library; None when no
    C compiler is there or the build fails."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        cc = os.environ.get("CC") or shutil.which("cc")
        out_dir = os.path.join(_BUILD_ROOT, _source_hash())
        so_path = os.path.join(out_dir, "libmpc80.so")
        try:
            if not os.path.exists(so_path):
                if cc is None:
                    raise OSError("no C compiler (cc) on PATH")
                os.makedirs(out_dir, exist_ok=True)
                tmp = f"{so_path}.{os.getpid()}.tmp"
                subprocess.run([cc, *_CC_FLAGS, "-o", tmp, _SRC, "-lm"], check=True, capture_output=True)
                os.replace(tmp, so_path)
            lib = ctypes.CDLL(so_path)
        except (subprocess.CalledProcessError, OSError):
            _build_failed = True
            return None
        lib.parse_mpc80.restype = ctypes.c_long
        lib.parse_mpc80.argtypes = [
            ctypes.c_char_p,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
            ctypes.c_char_p,
        ]
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether the native parser is built and in use."""
    return _build() is not None


def parse_file_native(path: str):
    """Parse an MPC 80-col file with the native parser.

    Returns ``(mjd_tt, ra, dec, mag, ids, obscodes, discovery, catalogs)``
    as numpy arrays (ids and codes stripped strings), or None if the native
    library is unavailable.
    """
    lib = _build()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    n_lines = buf.count(b"\n") + 2
    mjd = np.empty(n_lines)
    ra = np.empty(n_lines)
    dec = np.empty(n_lines)
    mag = np.empty(n_lines)
    ids = np.zeros(n_lines, dtype="S12")
    obscodes = np.zeros(n_lines, dtype="S3")
    disc = np.zeros(n_lines, dtype=np.int8)
    cats = np.zeros(n_lines, dtype="S1")
    dptr = ctypes.POINTER(ctypes.c_double)
    n = lib.parse_mpc80(
        buf,
        len(buf),
        mjd.ctypes.data_as(dptr),
        ra.ctypes.data_as(dptr),
        dec.ctypes.data_as(dptr),
        mag.ctypes.data_as(dptr),
        ids.ctypes.data_as(ctypes.c_char_p),
        obscodes.ctypes.data_as(ctypes.c_char_p),
        disc.ctypes.data_as(ctypes.c_char_p),
        cats.ctypes.data_as(ctypes.c_char_p),
    )
    return (
        mjd[:n],
        ra[:n],
        dec[:n],
        mag[:n],
        np.char.strip(ids[:n].astype("U12")),
        np.char.strip(obscodes[:n].astype("U3")),
        disc[:n].astype(bool),
        cats[:n].astype("U1"),
    )
