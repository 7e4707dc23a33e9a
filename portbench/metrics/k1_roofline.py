"""Kernel K1 (``csrc/chebyshev.cuh``): its least time, reckoned by
``portbench/roofline.py`` from each launch's shapes in the profiled call
(epochs, outputs, the table rows it reads), over the device time of the
kernels whose name holds ``chebyshev`` in the profiler's trace, in %."""

from portbench.roofline import k1_bound_s, touched_rows

HOOKS = [("args", "outfit_tpu_torch.ephem.chebyshev_cuda:evaluate")]
SITES = {"body": True, "frame": False}  # site -> with the derivative


def read(run):
    calls = run.calls.get(HOOKS[0][1], [])
    device_s = sum(v for k, v in run.profile.get("ops", {}).items() if "chebyshev" in k)
    if not calls or device_s <= 0:
        return None
    bound, seen = 0.0, {}
    for (coeffs, mjd, t0, gran, site), _ in calls:
        # the nine tables of one stage read the same epochs: one count each
        key = (mjd.data_ptr(), mjd.numel(), t0, gran, coeffs.shape[0])
        if key not in seen:
            seen[key] = touched_rows(mjd.detach().cpu().numpy(), t0, gran, coeffs.shape[0])
        bound += k1_bound_s(int(mjd.numel()), tuple(coeffs.shape), SITES[site], seen[key])
    return 100.0 * bound / device_s
