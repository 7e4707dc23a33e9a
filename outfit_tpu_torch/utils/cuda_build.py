"""Build a CUDA source of ``outfit_tpu_torch/csrc`` into a shared library.

The port's kernels take one route: ``nvcc`` compiles a ``.cu`` file with a
plain C interface for ``sm_90a`` into a shared library at first use, and
``ctypes`` loads it.  The library goes into ``_build/<hash>/`` beside the
package's sources, the hash taken over the sources it includes and the
flags, so that an edited source builds anew and an unchanged one is built
once per checkout.  Callers hold their own lock around :func:`build`.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(PKG, "csrc")
BUILD_ROOT = os.path.join(PKG, "_build")
#: ``-fmad=false``: no multiply-add contraction, so each product and sum
#: rounds alone, as PyTorch's elementwise operations round them in the
#: kernels' plain versions
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def source_hash(sources) -> str:
    """Hash of the files ``sources`` (names under :data:`CSRC`) and :data:`NVCC_FLAGS`."""
    h = hashlib.sha256()
    for name in sources:
        with open(os.path.join(CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def nvcc() -> str:
    for cand in (
        os.environ.get("NVCC"),
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set $NVCC or $CUDA_HOME, or put nvcc on PATH")


def build(sources, lib_name, build_root=BUILD_ROOT) -> tuple:
    """Compile ``sources[0]`` (which includes the rest of ``sources``) into
    ``<build_root>/<hash>/<lib_name>`` unless that file exists.

    Returns ``(path, compiler_output)``; the output holds ``ptxas``'s
    register and spill report when a build ran, else is empty."""
    out_dir = os.path.join(build_root, source_hash(sources))
    lib_path = os.path.join(out_dir, lib_name)
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, sources[0])]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, lib_path)
    return lib_path, proc.stdout + proc.stderr
