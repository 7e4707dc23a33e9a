"""Tensor construction helpers shared by the port's modules."""

import torch


def as_f64(x, device=None) -> torch.Tensor:
    """``x`` as a float64 tensor.  A tensor keeps its device; anything else
    (Python or numpy scalars and arrays) is placed on ``device``."""
    if isinstance(x, torch.Tensor):
        return x if x.dtype == torch.float64 else x.to(torch.float64)
    return torch.as_tensor(x, dtype=torch.float64, device=device)
