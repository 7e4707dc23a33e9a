"""Propagator dispatch: two-body or N-body with state transition matrix
(``PropagatorKind``, ``NBodyConfig``, the DOP853 + STM integrator)."""

from outfit_tpu_torch.propagator.config import NBodyConfig, PropagatorKind  # noqa: F401
from outfit_tpu_torch.propagator.nbody import propagate_nbody  # noqa: F401
from outfit_tpu_torch.propagator.dop853 import dop853_integrate  # noqa: F401
