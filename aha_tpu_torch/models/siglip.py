"""SigLIP vision tower over the bridged param dict.

Counterpart of ``aha_tpu/models/siglip.py`` (``forward``, ``layer_norm``,
``_mha``, ``preprocess_frames``). The JAX tower has no Pallas kernel, so its
matmuls and attention are plain PyTorch here. The patch-embedding kernel is
stored in torch's conv layout [H, 3, P, P] (the bridge converts JAX's
HWIO). The MAP probe head (``frame_token_cls``) is off the streaming path
and not ported.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from aha_tpu.config import SiglipConfig

from ..ops.quant import linear
from . import layer_view


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _mha(x: torch.Tensor, lp: dict, num_heads: int) -> torch.Tensor:
    B, T, H = x.shape
    d = H // num_heads
    q = linear(x, lp["q_proj"]).reshape(B, T, num_heads, d).transpose(1, 2)
    k = linear(x, lp["k_proj"]).reshape(B, T, num_heads, d).transpose(1, 2)
    v = linear(x, lp["v_proj"]).reshape(B, T, num_heads, d).transpose(1, 2)
    # products in the storage dtype, softmax in f32 (as the JAX tower)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).to(x.dtype)
    return linear(out.transpose(1, 2).reshape(B, T, H), lp["out_proj"])


def preprocess_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8/float [N, H, W, 3] -> (x / 255 - 0.5) / 0.5, fused as
    x * (2/255) - 1."""
    return (frames.float() * (2.0 / 255.0) - 1.0).to(dtype)


def forward(params: dict, cfg: SiglipConfig, pixels: torch.Tensor) -> torch.Tensor:
    """Normalised pixels [N, H, W, 3] -> patch features [N, num_patches, H]."""
    pe = params["patch_embed"]
    x = F.conv2d(pixels.permute(0, 3, 1, 2), pe["kernel"].to(pixels.dtype),
                 stride=cfg.patch_size)                     # [N, H, gh, gw]
    N = x.shape[0]
    x = x.permute(0, 2, 3, 1) + pe["bias"]
    x = x.reshape(N, cfg.num_patches, cfg.hidden_size) + params["pos_embed"]
    lyr = params["layers"]
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        h = layer_norm(x, lp["ln1"], cfg.layer_norm_eps)
        x = x + _mha(h, lp, cfg.num_heads)
        h = layer_norm(x, lp["ln2"], cfg.layer_norm_eps)
        h = linear(h, lp["fc1"])
        h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
        x = x + linear(h, lp["fc2"])
    return layer_norm(x, params["post_ln"], cfg.layer_norm_eps)
