"""Device selection shared by the port's entry points and kernel ops."""
from __future__ import annotations

import os
from typing import Union

import torch


def cap_test_threads() -> int:
    """Give torch's CPU thread pool this process's share of the cores.

    pytest-xdist runs ``PYTEST_XDIST_WORKER_COUNT`` worker processes side by
    side; each would otherwise keep one intra-op thread a core, and six such
    workers on eight cores spend most of their time contending. The test
    files call this at import. Returns the thread count set."""
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    n = max(1, (os.cpu_count() or 1) // workers)
    torch.set_num_threads(n)
    return n


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
