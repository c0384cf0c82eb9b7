"""Device selection for the port's entry points."""

from __future__ import annotations

import os

import torch
import torch.utils.deterministic

# cuBLAS reproducibility: a fixed workspace configuration (either value
# torch's deterministic mode accepts), read when the first cuBLAS handle is
# made
CUBLAS_WORKSPACE = ":4096:8"
DETERMINISTIC_WORKSPACES = (":4096:8", ":16:8")


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on (with its index, for a GPU): the
    GPU unless the caller asks for the CPU. Asking for CUDA without a usable
    GPU raises; nothing carries on silently on the CPU.

    Also turns TF32 off for convolutions and matrix products: the reference
    computes in full float32, and cuDNN would otherwise run float32
    convolutions in TF32 (about three decimal digits). And it turns off
    cuBLAS's reduced-precision reductions of bfloat16 products (on by
    default: a split-K GEMM may then add its partial sums in bfloat16): the
    reference's bfloat16 products (``--dtype bfloat16``) accumulate in
    float32 and round once, and on an H100 at GPT-2's widths the switch
    changed neither the time nor the error of a product (PERF.md, PR 7)."""
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
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


def make_reproducible() -> None:
    """Make this process's GPU work reproducible, as the reference's runs
    are: two runs of one seed give bitwise equal results. An entry point
    calls it once, before any CUDA work; calling it again changes nothing.
    The switches are process-wide (torch has no other kind), so a session
    built directly, without an entry point, leaves them as it finds them.

    cuDNN picks deterministic algorithms and does not benchmark, and
    ``torch.use_deterministic_algorithms`` makes every other operation with
    a nondeterministic CUDA implementation run a deterministic one or raise.
    That mode would also fill every ``torch.empty`` with NaN, a guard
    against reading memory nothing wrote; the port's kernels write every
    element of their outputs, and the fill cost about 1,400 launches and
    1.8 ms of device time a round, so it stays off. There is no switch to
    turn the rest off.

    cuBLAS reads ``CUBLAS_WORKSPACE_CONFIG`` when it makes its first handle,
    so the variable is set here if it is unset, and a value that is not
    deterministic raises. Set before the first cuBLAS call (as an entry
    point does), it takes effect; torch cannot tell whether a handle came
    earlier."""
    ws = os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    if ws not in DETERMINISTIC_WORKSPACES:
        raise RuntimeError(f"CUBLAS_WORKSPACE_CONFIG={ws!r} is not deterministic; unset it "
                           f"or set one of {DETERMINISTIC_WORKSPACES}")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    torch.utils.deterministic.fill_uninitialized_memory = False
