#!/usr/bin/env python3
"""The output check's readings: for each seed, one set-up and one short
window of a cell, then the check of the program's outputs (the lower
readings) and of each control's in their place (the upper readings).

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 --seconds 5 [--out file.jsonl]

The controls are listed in the traffic file's ``check.controls``:
``{"kind": "reference", "dtype": "float32"}`` puts the plain reference,
computed in that precision, in the program's place;
``{"kind": "program", "correction": {...}, "iod": {...}}`` runs the
program again on the window's traffic with those settings changed (the
program's own lower-precision path).  Each control has to fail one of the
cell's numbers.  Prints one JSON line per seed.
"""

import argparse
import json
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the numbers read, compared or not, by kind of check
READINGS = {
    "fits": ("missing_rows", "lost_convergence", "orbit_gap_sigma", "sigma_gap_rel", "rms_gap_rel", "iod_rms_gap_rel"),
    "propagation": ("bad_status", "position_gap_au", "velocity_gap_au_day", "partials_gap_rel",
                    "velocity_partials_gap_rel", "reference_unfinished"),
}


def fit_rows_from_reference(dtype):
    import numpy as np
    import torch

    from portbench import checks
    from portbench.reference import lsq

    def replace_with(run):
        def replace(x0, e0, obs, prog):
            """The correction from the start the program had, and the IOD
            stage's score of the program's preliminary orbits, both in
            ``dtype``."""
            ref = lsq.differential_correction(x0, e0, obs, run.config["correction"], dtype=dtype)
            low = lsq.Observations(obs.mjd, *(getattr(obs, k).to(dtype) for k in
                                              ("ra", "dec", "sigma_ra", "sigma_dec", "observer")), obs.valid)
            iod = np.where(np.isfinite(prog["iod_elements"]), prog["iod_elements"], 1.0)
            iod_rms = checks.iod_rms(torch.as_tensor(iod).to(dtype), torch.as_tensor(prog["iod_epoch"]), low)
            conv = (ref["status"] == lsq.OK).numpy()
            return dict(prog, converged=conv, status=ref["status"].numpy(), epoch=e0.numpy(),
                        elements=ref["elements"].to(torch.float64).numpy(),
                        covariance=ref["covariance"].to(torch.float64).numpy(),
                        rms=ref["rms"].to(torch.float64).numpy(), n_active=ref["n_active"].numpy(),
                        iod_rms=iod_rms.to(torch.float64).numpy())
        return replace
    return replace_with


def propagation_from_reference(dtype):
    from portbench.reference import nbody

    def replace_with(run):
        def replace(el, ep, t1, bodies):
            p, v, j, jv, _, _ = nbody.propagate(el, ep, t1, bodies, dtype=dtype)
            import numpy as np

            return (p.double().numpy(), v.double().numpy(), j.double().numpy(), jv.double().numpy(),
                    np.zeros(len(t1), np.int64))
        return replace
    return replace_with


def readings(cell, seed, seconds, devices=None, overrides=None):
    import torch

    from portbench import harness

    bench = harness.load_benchmark()
    wl, config, traffic, driver = harness.resolve(bench, cell)
    traffic = dict(traffic, **(overrides or {}))
    if devices is None:
        devices = harness.cuda_devices(wl["chips"])
    run = harness.Run(cell, seed, seconds, False, bench, wl, config, traffic, devices)
    run.state = driver.setup(run)
    driver.call(run, -1)
    run.t_start = time.perf_counter()
    run.records = driver.window(run, run.t_start + seconds)
    run.t_end = run.records[-1]["t1"]
    driver.tally(run)
    # every number, whatever the traffic file compares
    run.traffic = traffic = dict(traffic, check=dict(traffic["check"], limits={
        k: math.inf for k in READINGS["propagation" if traffic["driver"] == "propagate" else "fits"]}))
    program = driver.check(run)
    controls = {}
    for ctl in traffic["check"]["controls"]:
        if ctl["kind"] == "reference":
            dtype = getattr(torch, ctl["dtype"])
            make = (propagation_from_reference if traffic["driver"] == "propagate" else fit_rows_from_reference)(dtype)
            numbers = driver.check(run, replace=make(run))
        else:
            alt = dict(config, **{k: dict(config[k], **v) for k, v in ctl.items() if k != "kind"})
            run2 = harness.Run(cell, seed, seconds, False, bench, wl, alt, traffic, devices)
            run2.state = driver.setup(run2)
            run2.records = [driver.call(run2, i) for i in range(len(run.records))]
            driver.tally(run2)
            numbers = driver.check(run2)
        controls[label(ctl)] = {n["name"]: n["value"] for n in numbers}
    return dict(cell=cell, seed=seed, calls=len(run.records),
                program={n["name"]: n["value"] for n in program}, controls=controls)


def label(ctl):
    """A control's short name: ``reference.float32``, ``program.mixed``."""
    if ctl["kind"] == "reference":
        return f"reference.{ctl['dtype']}"
    return "program." + ".".join(str(v) for k, part in ctl.items() if k != "kind" for v in part.values())


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    for seed in args.seeds:
        line = json.dumps(readings(args.workload, seed, args.seconds))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a", encoding="utf-8") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
