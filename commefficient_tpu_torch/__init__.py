"""PyTorch/CUDA port of commefficient_tpu: FetchSGD-family federated training
with hand-written CUDA Count-Sketch kernels. Imports torch, numpy and the
standard library only; entry points run on the GPU unless the caller passes
device="cpu"."""
