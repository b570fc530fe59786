"""Device selection shared by the port's entry points and kernel ops."""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU. Raises when CUDA is asked for and absent; nothing falls back
    to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(dev)!r} requested but CUDA is not "
                           "available")
    return dev


def on_cpu(t: torch.Tensor, what: str) -> bool:
    """Whether ``t`` takes a kernel's plain version: True on the CPU, False
    on CUDA (the hand-written kernel); raises for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or the CPU, not {t.device}")
    return False
