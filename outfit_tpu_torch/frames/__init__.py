"""Earth orientation and reference-frame rotations on tensors."""

from outfit_tpu_torch.frames.earth_orientation import equequ, nutn80, obleq, prec, rnut80
from outfit_tpu_torch.frames.ref_system import RefEpoch, RefSystem, rotmt, rotpn

__all__ = [
    "equequ", "nutn80", "obleq", "prec", "rnut80",
    "RefEpoch", "RefSystem", "rotmt", "rotpn",
]
