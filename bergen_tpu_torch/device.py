"""Device resolution for the port's entry points.

Every entry point runs on ``cuda`` unless the caller asks for ``cpu``.
Asking for ``cuda`` on a machine without a usable card raises: the port
never carries on silently on the CPU.
"""

from __future__ import annotations

import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' was asked for but torch.cuda.is_available() is "
                "false; pass device='cpu' (CLI: device=cpu) to run on the CPU")
        return torch.device("cuda", dev.index if dev.index is not None
                            else torch.cuda.current_device())
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def default_dtype(device: torch.device, dtype: str | None) -> torch.dtype:
    """bf16 on the card (the kernels' type), f32 on the CPU, unless forced
    with 'f32'/'float32'/'bf16' (the JAX package's ``dtype`` argument)."""
    if dtype is not None:
        return {"f32": torch.float32, "float32": torch.float32,
                "bf16": torch.bfloat16}[dtype]
    return torch.bfloat16 if device.type == "cuda" else torch.float32
