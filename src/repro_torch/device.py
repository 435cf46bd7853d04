"""Where the port runs: the card unless the caller asks for the CPU.

``is_fake`` tells a ``FakeTensorMode`` tensor (shape, dtype and device,
no storage; the dry run's) from a real one: a kernel wrapper gives a fake
tensor its kernel's shape rule, never the plain version, and a dry mesh
takes nothing else."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` means the CUDA device.  Raises when CUDA is asked for (or
    defaulted to) and this process has none — the port never falls back to
    the CPU on its own; pass ``device="cpu"`` for the plain PyTorch path."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available in this process; pass device='cpu' to run"
            " the port's plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"the port runs on 'cuda' or 'cpu', got {dev}")
    return dev


def is_fake(t) -> bool:
    """True for a ``FakeTensorMode`` tensor."""
    from torch._subclasses.fake_tensor import FakeTensor

    return isinstance(t, FakeTensor)
