"""Count-Sketch: hashing, the plain PyTorch operations, and the CUDA kernels
of the rotation family."""

from .csvec import CSVecSpec

__all__ = ["CSVecSpec"]
