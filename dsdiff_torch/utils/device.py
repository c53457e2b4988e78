"""Device resolution for the port's entry points.

Entry points default to ``"cuda"`` and raise when no card is present: the
port never falls back to the CPU on its own. Tests pass ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "disable_tf32", "full_f32"]


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """``device`` (default ``"cuda"``) as a ``torch.device``; raises if it
    names CUDA and no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def disable_tf32() -> None:
    """Full-f32 matmuls and convolutions, for parity runs on the card
    (cuDNN convolutions default to TF32, which keeps ~3 decimal digits)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def full_f32():
    """TF32 off for matmuls and convolutions inside the block, restored
    after it."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    disable_tf32()
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
