#!/usr/bin/env python3
"""Device time of the Chebyshev kernel K1 against its bound, beside three
other designs of it.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_k1/bench.py [--out FILE]

At the observer cache's query shapes, each in path order and shuffled (one
fixed permutation):

* real cadence: the 4096-trajectory workload of ``chip_smoke.py`` phase 4,
  309,892 epochs padded to 524,288;
* synthetic: the 8192 x 12 workload of phase 6, 98,304 epochs padded to
  131,072;

it times the three tables the cache evaluates (EMB and Moon, 3 channels
with the derivative, and the dataset's 10-channel frame table) through the
port's kernel (``outfit_tpu_torch/csrc/chebyshev.cuh``) and through the
three designs of ``tools/torch_k1/variants.cu`` (the first design, per-lane
row reads without staging, and rows staged by TMA bulk copies), built here
with nvcc into the gitignored ``tools/torch_k1/_build/``.  Each time is the device time per launch by
CUDA events around 20 launches queued behind a sleep kernel
(``chip_smoke.device_ms``), the median of 3.  Every variant is held
bitwise to the port's output.  Prints one line per measurement and writes
them all as JSON to ``--out`` (by default
``tools/torch_k1/_build/k1_bench.json``).
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

VARIANTS = {1: "first", 2: "warp_ldg", 3: "tma"}


def build_variants():
    """Compile variants.cu with the port's nvcc flags; returns k1_variant."""
    from outfit_tpu_torch.utils.cuda_build import NVCC_FLAGS, nvcc

    out_dir = os.path.join(HERE, "_build")
    os.makedirs(out_dir, exist_ok=True)
    lib = os.path.join(out_dir, "libk1_variants.so")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", lib, os.path.join(HERE, "variants.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    fn = ctypes.CDLL(lib).k1_variant
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_double, ctypes.c_double, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def cases(dev):
    """{(workload, order): (epochs on the card, frame table, t0, gran)}."""
    import numpy as np
    import torch

    from outfit_tpu_torch import JPLEphem
    from outfit_tpu_torch.observer.cache import _frame_table, frame_granules

    eph = JPLEphem.analytic(*chip_smoke.SPAN)
    out = {}
    real, _ = chip_smoke.real_cadence_dataset(chip_smoke.N_TRAJ)
    synth = chip_smoke.synthetic_dataset(chip_smoke.N_SYNTH, chip_smoke.N_SYNTH_OBS, eph)
    for name, ds in (("real", real), ("synthetic", synth)):
        q = chip_smoke.padded_queries(ds.mjd_tt)
        n_gran, gran, t0 = frame_granules(ds.mjd_tt)
        frame = _frame_table(t0, gran, n_gran, dev)
        for order, qq in (("path", q), ("shuffled", np.random.default_rng(1).permutation(q))):
            out[(name, order)] = (torch.as_tensor(qq, dtype=torch.float64, device=dev), frame, t0, gran)
    return eph.to(dev), out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(HERE, "_build", "k1_bench.json"))
    args = ap.parse_args()

    dev = chip_smoke.phase_device()
    import torch

    from outfit_tpu_torch.ephem import chebyshev_cuda
    from outfit_tpu_torch.ephem.bodies import Body

    chip_smoke.phase_build()
    variant = build_variants()
    eph, inputs = cases(dev)
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for (work, order), (mjd, frame, f_t0, f_gran) in inputs.items():
        n = mjd.shape[0]
        sites = [(b.name, eph.tables[b].coeffs, eph.tables[b].t0, eph.tables[b].granule_days, "body")
                 for b in (Body.EMB, Body.MOON)]
        sites.append(("frame", frame, f_t0, f_gran, "frame"))
        for table, coeffs, t0, gran, site in sites:
            deriv = site == "body"
            ch = coeffs.shape[1]
            bound, bound_by = chip_smoke.k1_bound_ms(n, tuple(coeffs.shape), deriv)
            ref, dref = chebyshev_cuda.evaluate(coeffs, mjd, t0, gran, site)
            out = torch.empty((n, ch), dtype=torch.float64, device=dev)
            dout = torch.empty((n, ch), dtype=torch.float64, device=dev) if deriv else None

            def run(v, coeffs=coeffs, t0=t0, gran=gran, out=out, dout=dout):
                err = variant(v, coeffs.data_ptr(), coeffs.shape[0], ch, coeffs.shape[2], mjd.data_ptr(), n,
                              float(t0), float(gran), out.data_ptr(), None if dout is None else dout.data_ptr(),
                              stream)
                if err != 0:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")

            runs = {"port": lambda: chebyshev_cuda.evaluate(coeffs, mjd, t0, gran, site)}
            runs.update({name: lambda v=v, f=run: f(v) for v, name in VARIANTS.items()})
            for name, launch in runs.items():
                same = None
                if name != "port":
                    launch()
                    torch.cuda.synchronize()
                    same = bool(torch.equal(out, ref) and (dout is None or torch.equal(dout, dref)))
                ms = chip_smoke.device_ms(launch)
                row = dict(workload=work, order=order, n=n, table=table, impl=name, device_ms=ms,
                           bound_ms=bound, bound_by=bound_by, share=bound / ms, bitwise_equal_to_port=same)
                rows.append(row)
                print(json.dumps(row), flush=True)
                if same is False:
                    raise AssertionError(f"{name} differs from the port's kernel: {row}")
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w", encoding="utf-8") as fh:
        json.dump({"device": torch.cuda.get_device_name(0), "rows": rows}, fh, indent=1)
    print(f"wrote {os.path.relpath(args.out, ROOT)}")


if __name__ == "__main__":
    main()
