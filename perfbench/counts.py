"""Operations and bytes of the benchmark's work, from shapes alone, and the
published peaks they are divided by.

Peaks: NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit: 67 TFLOP/s float32 outside the tensor cores (the rate of a float32
product with TF32 off, as the system runs), 3.35 TB/s of HBM bandwidth.
"""

from __future__ import annotations

H100_FP32_FLOPS = 67e12
H100_HBM_BYTES_PER_S = 3.35e12


def resnet9_macs_per_image(num_classes: int = 10, hw: int = 32) -> int:
    """Multiply-accumulates of one ResNet-9 forward over one image: every
    3x3 convolution at its feature map's size, and the linear layer."""
    convs = [(hw, 3, 64), (hw, 64, 128),  # prep; layer1 (then pool 2)
             (hw // 2, 128, 128), (hw // 2, 128, 128),  # res1
             (hw // 2, 128, 256),  # layer2 (then pool 2)
             (hw // 4, 256, 512),  # layer3 (then pool 2)
             (hw // 8, 512, 512), (hw // 8, 512, 512)]  # res2
    return sum(s * s * cin * cout * 9 for s, cin, cout in convs) + 512 * num_classes


def resnet9_train_flops(images: int, num_classes: int = 10) -> float:
    """Forward and backward (3x the forward's 2 FLOPs a MAC), no
    recomputation."""
    return 3 * 2 * resnet9_macs_per_image(num_classes) * images


def gpt2_matmul_params(cfg: dict) -> int:
    """Parameters that enter a matrix product: the four dense layers of
    every block and the tied head."""
    C = cfg["n_embd"]
    per_block = C * 3 * C + C * C + C * 4 * C + 4 * C * C
    return cfg["n_layer"] * per_block + cfg["vocab_size"] * C


def gpt2_train_flops(cfg: dict, tokens: int, ctx: int) -> float:
    """6 N T for the products with the weights, and 12 L d T_ctx per token
    for the attention scores and their weighted sum (forward 4 L d T_ctx,
    backward twice that), over the whole context as the products compute
    it."""
    N = gpt2_matmul_params(cfg)
    return 6.0 * N * tokens + 12.0 * cfg["n_layer"] * cfg["n_embd"] * ctx * tokens


def round_flops(model_cfg: dict, W: int, rows: int) -> float:
    """Model FLOPs of one round: W clients' forward and backward over their
    batches of ``rows`` examples (or sequences)."""
    if model_cfg["model"] == "resnet9":
        return resnet9_train_flops(W * rows, model_cfg["num_classes"])
    T = model_cfg["data"]["seq_len"]
    return gpt2_train_flops(model_cfg, W * rows * T, T)


def sketch_bytes(d: int, r: int, c: int) -> int:
    """Bytes a dense sketch or a whole query moves at least: the float32
    [d] vector once and the [r, c] table once."""
    return 4 * d + 4 * r * c


def roofline_share(nbytes: float, seconds: float) -> float:
    """% of the bandwidth bound that ``seconds`` of device time reach."""
    return 100.0 * nbytes / H100_HBM_BYTES_PER_S / seconds
