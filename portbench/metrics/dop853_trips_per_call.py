"""DOP853 loop (``propagator/dop853.py``): loop trips per call, counted
from outside as the calls of the N-body right-hand side's
``_acceleration_and_gradient`` (13 per trip) over the traced window."""

HOOKS = [("count", "outfit_tpu_torch.propagator.nbody:_acceleration_and_gradient")]
STAGES_PER_TRIP = 13


def read(run):
    n = run.counts.get(HOOKS[0][1])
    return n / STAGES_PER_TRIP / len(run.records) if n else None
