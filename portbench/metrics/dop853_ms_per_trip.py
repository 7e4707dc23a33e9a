"""DOP853 loop: synchronised wall of ``dop853_integrate`` in milliseconds
per loop trip over the traced window (trips counted as in
``dop853_trips_per_call``)."""

HOOKS = [("span", "outfit_tpu_torch.propagator.nbody:dop853_integrate"),
         ("count", "outfit_tpu_torch.propagator.nbody:_acceleration_and_gradient")]
STAGES_PER_TRIP = 13


def read(run):
    t, n = run.spans.get(HOOKS[0][1]), run.counts.get(HOOKS[1][1])
    return 1e3 * sum(t) / (n / STAGES_PER_TRIP) if t and n else None
