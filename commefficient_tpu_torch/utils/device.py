"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on (with its index, for a GPU): the
    GPU unless the caller asks for the CPU. Asking for CUDA without a usable GPU raises; nothing carries on
    silently on the CPU.

    Also turns TF32 off for convolutions and matrix products: the reference
    computes in full float32, and cuDNN would otherwise run float32
    convolutions in TF32 (about three decimal digits)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # an indexed device: threads of the run loop select it by index
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return dev
