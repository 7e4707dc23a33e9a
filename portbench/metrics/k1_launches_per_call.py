"""N-body right-hand side and K1 (``propagator/nbody.py``,
``ephem/chebyshev_cuda.py``): kernel launches per call, from the
program's counter ``chebyshev_cuda.launches`` over the traced window."""

HOOKS = [("counter", "outfit_tpu_torch.ephem.chebyshev_cuda:launches")]


def read(run):
    n = run.counts.get(HOOKS[0][1])
    return n / len(run.records) if n else None
