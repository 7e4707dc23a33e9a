"""Tensor construction helpers shared by the port's modules."""

import torch


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor.  A tensor keeps its device; anything else
    (Python or numpy scalars and arrays) is placed on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means ``"cuda"`` when a card is
    present, else ``"cpu"``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device)


_CONSTANTS = {}


def device_constant(array, device, dtype=torch.float64) -> torch.Tensor:
    """The module-level numpy constant ``array`` as a tensor on ``device``,
    uploaded once per (array, device, dtype) and shared: uploading a host
    array on every call is a blocking copy that waits for the card's queue.
    Callers must not modify the result."""
    key = (id(array), torch.device(device), dtype)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.as_tensor(array, dtype=dtype, device=device)
    return t
