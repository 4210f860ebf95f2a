"""Device resolution for every entry point of the port.

The card is the default: ``resolve(None)`` and ``resolve("cuda")`` give
the current CUDA device, and raise when there is none — a run meant for
the GPU never carries on quietly on the CPU.  The CPU is taken only when
the caller names it (``device="cpu"``, ``--device cpu``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """``None`` / ``"cuda"`` / ``"cuda:N"`` -> a CUDA device (raises
    ``RuntimeError`` without one); ``"cpu"`` -> the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "(--device cpu) to run the plain CPU path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
