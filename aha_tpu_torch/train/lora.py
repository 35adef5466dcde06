"""LoRA adapters for the layer-stacked Qwen2 decoder.

Counterpart of ``aha_tpu/train/lora.py``: one adapter pair per projection,
stacked on the layer axis like the base weights,
``{proj: {"a": [L, in, r], "b": [L, r, out]}}``; the delta is applied at the
matmul site (``models/qwen2.py``), never by materialising W + BA, with the
effective scale alpha / r. ``trainable_labels`` is the partition the trainer
and the optimizer share: adapters always train; of the base params only the
``finetune_modules`` (projector, lm_head, score heads) do.
"""

from __future__ import annotations

import re

import torch

from ..config import LoraConfig, QwenConfig
from ..models import jax_random

LORA_PROJS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")

_HEAD_MODULES = {"informative": "informative_head", "relevance": "relevance_head",
                 "uncertainty": "uncertainty_head"}


def proj_dims(cfg: QwenConfig) -> dict[str, tuple[int, int]]:
    H, I, QD, KD = cfg.hidden_size, cfg.intermediate_size, cfg.q_dim, cfg.kv_dim
    return {
        "q_proj": (H, QD),
        "k_proj": (H, KD),
        "v_proj": (H, KD),
        "o_proj": (QD, H),
        "gate_proj": (H, I),
        "up_proj": (H, I),
        "down_proj": (I, H),
    }


def init_lora(cfg: QwenConfig, lora_cfg: LoraConfig, *, seed: int = 0,
              dtype=torch.float32, device="cuda") -> dict:
    """A ~ kaiming-uniform (peft's default), B = 0, so the initial delta is 0.
    Projections are selected by ``lora_cfg.target_patterns`` (the default
    matches all seven decoder projections). A is JAX's draw bit for bit: the
    key ``PRNGKey(seed)`` split into one key a projection, each drawn by
    ``jax.random.uniform`` on the port's threefry (``models/jax_random.py``),
    so the trainer starts from the adapters JAX's starts from. Built on the
    card unless ``device`` says otherwise."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_lora: device cuda requested but no GPU is available "
                           "(pass device='cpu' to build on the host)")
    pattern = re.compile(lora_cfg.target_patterns)
    L, r = cfg.num_layers, lora_cfg.r
    keys = jax_random.split(jax_random.prng_key(seed), len(LORA_PROJS))
    tree = {}
    for key, (name, (din, dout)) in zip(keys, proj_dims(cfg).items()):
        if not pattern.search(f"layers_0/{name}/kernel"):
            continue
        bound = (6.0 / din) ** 0.5   # kaiming_uniform(a=sqrt(5)) on [r, din]
        a = jax_random.uniform(key, (L, din, r), -bound, bound, device=device)
        tree[name] = {"a": a.reshape(L, din, r).to(dtype),
                      "b": torch.zeros((L, r, dout), dtype=dtype, device=device)}
    return tree


def lora_scale(lora_cfg: LoraConfig) -> float:
    return lora_cfg.alpha / lora_cfg.r


def merge_lora(llm_params: dict, lora: dict, scale: float) -> dict:
    """Fold adapters into DENSE split-projection kernels (export, or fast
    frozen inference). The input tree is not modified."""
    layers = dict(llm_params["layers"])
    for name, ab in lora.items():
        p = dict(layers[name])
        if isinstance(p["kernel"], dict):
            raise ValueError(f"merge_lora: {name} is quantised; merge into dense kernels")
        delta = torch.einsum("lir,lro->lio", ab["a"].float(), ab["b"].float()) * scale
        p["kernel"] = p["kernel"] + delta.to(p["kernel"].dtype)
        layers[name] = p
    return {**llm_params, "layers": layers}


def trainable_labels(params: dict, lora: dict | None,
                     finetune_modules: tuple[str, ...]) -> dict:
    """'train' / 'freeze' for every leaf of {"model": params, "lora": lora}:
    adapters always train; of the base params only ``finetune_modules``
    (projector, lm_head, score heads) do; the vision tower and the decoder
    trunk stay frozen."""

    def label(path: tuple[str, ...]) -> str:
        if path[0] == "projector" and "mm_projector" in finetune_modules:
            return "train"
        if path[:2] == ("llm", "lm_head") and "lm_head" in finetune_modules:
            return "train"
        if path[0] == "heads" and _HEAD_MODULES.get(path[1]) in finetune_modules:
            return "train"
        return "freeze"

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        return label(path)

    out = {"model": visit(params, ())}
    if lora is not None:
        out["lora"] = {n: {k: "train" for k in ab} for n, ab in lora.items()}
    return out
