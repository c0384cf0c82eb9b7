"""Tiny cells for the benchmark's CPU tests: a directory laid out as a
checkout (BENCHMARK.json, ``perfbench/configs``, ``workloads`` and
``metrics``), holding the benchmark's own metric readers and small
configurations of its two models."""

from __future__ import annotations

import copy
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)

TINY_GPT2 = {
    "model": "gpt2", "vocab_size": 512, "n_positions": 64, "n_ctx": 64, "n_embd": 32,
    "n_layer": 2, "n_head": 2, "activation_function": "gelu_new",
    "layer_norm_epsilon": 1e-5, "resid_pdrop": 0.0, "embd_pdrop": 0.0, "attn_pdrop": 0.0,
    "tie_word_embeddings": True, "dtype": "float32",
    "data": {"kind": "text", "num_clients": 40, "rows_per_client": 2, "seq_len": 32},
    "fetchsgd": {"hash_family": "rotation", "num_rows": 5, "num_cols": 4096, "num_blocks": 1,
                 "k": 500, "momentum": 0.9, "weight_decay": 0.0005, "lr": 0.1},
}
TINY_RESNET9 = {
    "model": "resnet9", "num_classes": 10, "logit_scale": 0.125, "dtype": "float32",
    "data": {"kind": "images", "num_examples": 40, "shape": [32, 32, 3], "num_clients": 20},
    "fetchsgd": {"hash_family": "rotation", "num_rows": 5, "num_cols": 524288, "num_blocks": 1,
                 "k": 2000, "momentum": 0.9, "weight_decay": 0.0005, "lr": 0.1},
}
LIMITS = {"loss_gap": 1e-5, "grad_gap": 1e-5, "change_gap": 1e-4}


def workload(traffic: str, mode: str, W: int, rows: int) -> dict:
    return {"traffic": traffic, "mode": mode, "clients_per_round": W, "rows_per_client": rows,
            "client_chunk": 0, "checked_rounds": 3, "warmup_rounds": 1, "trace_rounds": 4,
            "limits": dict(LIMITS)}


def make_root(path: str, cells: dict | None = None, configs: dict | None = None) -> str:
    """A checkout-like directory at ``path`` whose BENCHMARK.json is the
    repository's with the given tiny configurations and cells in place of
    its own (name -> (config name, workload dict)); the metric readers
    are the repository's files."""
    configs = configs or {"tiny-gpt2": TINY_GPT2, "tiny-resnet9": TINY_RESNET9}
    cells = cells or {
        "tiny-gpt2-sketch": ("tiny-gpt2", workload("t-sketch", "sketch", 4, 2)),
        "tiny-gpt2-uncompressed": ("tiny-gpt2", workload("t-unc", "uncompressed", 4, 2)),
        "tiny-resnet9-sketch": ("tiny-resnet9", workload("t-sketch", "sketch", 2, 2)),
    }
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench = copy.deepcopy(bench)
    os.makedirs(os.path.join(path, "perfbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(path, "perfbench", "workloads"), exist_ok=True)
    metrics = os.path.join(path, "perfbench", "metrics")
    if not os.path.isdir(metrics):
        shutil.copytree(os.path.join(BENCH, "metrics"), metrics)
    bench["configs"] = []
    for name, cfg in configs.items():
        file = f"perfbench/configs/{name}.json"
        with open(os.path.join(path, file), "w") as f:
            json.dump(cfg, f)
        bench["configs"].append({"name": name, "source": "tiny", "file": file, "reduced": [],
                                 "why": "a CPU test"})
    bench["workloads"] = []
    for name, (config, w) in cells.items():
        with open(os.path.join(path, "perfbench", "workloads", f"{name}.json"), "w") as f:
            json.dump(w, f)
        bench["workloads"].append({"name": name, "config": config, "traffic": w["traffic"],
                                   "chips": 1, "why": "a CPU test"})
    for m in bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [n for n, (_, w) in cells.items() if w["mode"] == "sketch"]
    with open(os.path.join(path, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return path
