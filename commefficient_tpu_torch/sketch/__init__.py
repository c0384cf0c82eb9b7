"""Count-Sketch: hashing, the plain PyTorch operations, and the CUDA kernels
of the rotation family.

``CSVecSpec`` resolves on first access (PEP 562): ``sketch.payload``, the
wire codec, is numpy-only, and a shard worker process imports it through
this package without torch."""


def __getattr__(name):
    if name == "CSVecSpec":
        from .csvec import CSVecSpec

        return CSVecSpec
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["CSVecSpec"]
