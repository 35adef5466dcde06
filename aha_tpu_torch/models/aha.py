"""The Aha model's vision path, projector and score heads, plus seeded
synthetic params built on the device.

Counterpart of ``aha_tpu/models/aha.py`` (``encode_vision_tokens``,
``project_features``, ``visual_embed``), of the heads in
``aha_tpu/streaming/engine_core.py::_scores_from_hidden``, and of
``aha_tpu/models/loader.py::materialize_random_params`` (``random_params``).
Only the SigLIP tower without the CLS probe (``frame_token_cls=False``) is
on the streaming path and ported.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from aha_tpu.config import AhaConfig

from ..ops.pooling import pool_patch_tokens
from ..ops.preprocess import device_letterbox
from ..ops.quant import linear
from . import siglip

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def project_features(params: dict, feats: torch.Tensor) -> torch.Tensor:
    """llava mlp2x_gelu projector: Linear -> exact GELU (f32) -> Linear."""
    p = params["projector"]
    x = linear(feats, p["fc1"])
    x = F.gelu(x.float()).to(feats.dtype)
    return linear(x, p["fc2"])


def encode_vision_tokens(params: dict, cfg: AhaConfig, frames: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """frames [N, H, W, 3] of any size -> pooled features [N, F, Hv]."""
    if cfg.vision.arch != "siglip" or cfg.frame_token_cls:
        raise NotImplementedError(
            "aha_tpu_torch ports the SigLIP tower without the CLS probe only "
            "(ROADMAP.md, Queue 1 item 3)")
    if tuple(frames.shape[1:3]) != (cfg.frame_resolution, cfg.frame_resolution):
        frames = device_letterbox(frames, cfg.frame_resolution)
    pixels = siglip.preprocess_frames(frames, dtype)
    spatial = siglip.forward(params["vision"], cfg.vision, pixels)
    return pool_patch_tokens(spatial, cfg.vision.grid_size, cfg.frame_token_pooled,
                             cfg.pooling_mode)


def visual_embed(params: dict, cfg: AhaConfig, frames: torch.Tensor) -> torch.Tensor:
    """frames [N, H, W, 3] (uint8 or float pixels) -> [N, F, H_llm]."""
    k = params["projector"]["fc1"]["kernel"]
    dtype = torch_dtype(cfg.dtype) if isinstance(k, dict) else k.dtype
    feats = encode_vision_tokens(params, cfg, frames, dtype)
    return project_features(params, feats)


def scores_from_hidden(params: dict, hidden_last: torch.Tensor) -> torch.Tensor:
    """[..., H] -> [..., 3] f32: softmax(informative)[1], sigmoid(relevance),
    exp(log-variance)."""
    hf = hidden_last.float()
    heads = params["heads"]
    info = hf @ heads["informative"]["kernel"].float()
    rel = hf @ heads["relevance"]["kernel"].float()
    unc = hf @ heads["uncertainty"]["kernel"].float()
    return torch.stack([torch.softmax(info, dim=-1)[..., 1],
                        torch.sigmoid(rel[..., 0]), torch.exp(unc[..., 0])], dim=-1)


def random_params(cfg: AhaConfig, *, device="cpu", seed: int = 0) -> dict:
    """Synthetic params of the int8 deployment config, built leaf by leaf on
    ``device`` in their final dtype, with the recipe of
    ``loader.materialize_random_params(cfg, "int8")``: int8 values uniform
    in [-127, 127] with scales 0.02/127, dense kernels normal(0, 0.02),
    norms one, biases zero. Every decoder projection (merged qkv / gate_up,
    the layout the TPU engine serves), the projector, the embedding table
    and the lm_head are int8; the vision tower and the heads stay dense.
    Deterministic for a seed, not bit-equal to JAX's PRNG."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def kernel(*shape, per_row=False):
        """[.., K, N] kernel; int8 with per-column scales [.., 1, N] (or,
        for an embedding table, per-row scales [V, 1])."""
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        sshape = (*shape[:-1], 1) if per_row else (*shape[:-2], 1, shape[-1])
        return {"qvalue": q, "scale": torch.full(sshape, 0.02 / 127.0,
                                                 dtype=torch.float32, device=device)}

    v, q = cfg.vision, cfg.llm
    L, H, I = q.num_layers, q.hidden_size, q.intermediate_size
    QD, KD = q.q_dim, q.kv_dim
    Lv, Hv, Iv, P = v.num_layers, v.hidden_size, v.intermediate_size, v.patch_size
    vision = {
        "patch_embed": {"kernel": normal(Hv, 3, P, P), "bias": zeros(Hv)},
        "pos_embed": normal(v.num_patches, Hv),
        "layers": {
            "ln1": {"scale": ones(Lv, Hv), "bias": zeros(Lv, Hv)},
            **{n: {"kernel": normal(Lv, Hv, Hv), "bias": zeros(Lv, Hv)}
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln2": {"scale": ones(Lv, Hv), "bias": zeros(Lv, Hv)},
            "fc1": {"kernel": normal(Lv, Hv, Iv), "bias": zeros(Lv, Iv)},
            "fc2": {"kernel": normal(Lv, Iv, Hv), "bias": zeros(Lv, Hv)},
        },
        "post_ln": {"scale": ones(Hv), "bias": zeros(Hv)},
    }
    llm = {
        "embed": {"weight": kernel(q.vocab_size, H, per_row=True)},
        "layers": {
            "input_norm": {"scale": ones(L, H)},
            "qkv_proj": {"kernel": kernel(L, H, QD + 2 * KD), "bias": zeros(L, QD + 2 * KD)},
            "o_proj": {"kernel": kernel(L, QD, H)},
            "post_norm": {"scale": ones(L, H)},
            "gate_up_proj": {"kernel": kernel(L, H, 2 * I)},
            "down_proj": {"kernel": kernel(L, I, H)},
        },
        "final_norm": {"scale": ones(H)},
    }
    if not q.tie_word_embeddings:
        llm["lm_head"] = {"kernel": kernel(H, q.vocab_size)}
    return {
        "vision": vision,
        "projector": {"fc1": {"kernel": kernel(Hv, H), "bias": zeros(H)},
                      "fc2": {"kernel": kernel(H, H), "bias": zeros(H)}},
        "llm": llm,
        "heads": {"informative": {"kernel": normal(H, 2)},
                  "relevance": {"kernel": normal(H, 1)},
                  "uncertainty": {"kernel": normal(H, 1)}},
    }
