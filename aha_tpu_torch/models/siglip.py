"""SigLIP vision tower over the bridged param dict.

Counterpart of ``aha_tpu/models/siglip.py`` (``forward``, ``layer_norm``,
``_mha``, ``preprocess_frames``). The JAX tower has no Pallas kernel, so its
matmuls and attention are plain PyTorch here, except where the tower is
quantised (``--vision_int8``, ``--w8a8``): its q/k/v/out and fc1/fc2 products
then run ``ops.quant.linear``'s int8 kernels on the session's ``backend``, as
JAX's ``qlinear`` serves them. The patch-embedding kernel is
stored in torch's conv layout [H, 3, P, P] (the bridge converts JAX's
HWIO). ``attention_pool`` is the MAP probe head, the CLS token of
``frame_token_cls``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..config import SiglipConfig
from ..ops.quant import linear
from . import layer_view


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * p["scale"].float() + p["bias"].float()).to(x.dtype)


def _mha(x: torch.Tensor, lp: dict, num_heads: int, backend: str = "fused",
         sh=None) -> torch.Tensor:
    """Self-attention. Under ``sh`` (a ``parallel.sharded.Shard`` of the
    layer's specs) q/k/v run on the rank's heads where they stay whole,
    out_proj reduces over ``model``."""
    B, T, H = x.shape
    d = H // num_heads
    if sh is None:
        q, k, v = (linear(x, lp[n], backend).reshape(B, T, num_heads, d).transpose(1, 2)
                   for n in ("q_proj", "k_proj", "v_proj"))
    else:
        outs = [sh.linear(x, lp[n], sh.specs[n], backend) for n in ("q_proj", "k_proj", "v_proj")]
        local = sh.heads_local(num_heads, num_heads) and all(sp for _, sp in outs)
        outs = [t if local else sh.full(t, sp) for t, sp in outs]
        nh = num_heads // (sh.M if local else 1)
        q, k, v = (t.reshape(B, T, nh, d).transpose(1, 2) for t in outs)
    # products in the storage dtype, softmax in f32 (as the JAX tower)
    scores = torch.matmul(q, k.transpose(-1, -2)).float() * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs, v).to(x.dtype)
    out = out.transpose(1, 2).reshape(B, T, -1)
    if sh is None:
        return linear(out, lp["out_proj"], backend)
    y, split = sh.linear(out, lp["out_proj"], sh.specs["out_proj"], backend,
                         x_split=q.shape[1] != num_heads)
    return sh.full(y, split)


def mlp(h: torch.Tensor, lp: dict, act, backend: str = "fused", sh=None) -> torch.Tensor:
    """fc2(act(fc1(h))); under ``sh`` fc1 column- and fc2 row-parallel."""
    if sh is None:
        return linear(act(linear(h, lp["fc1"], backend)), lp["fc2"], backend)
    y, split = sh.linear(h, lp["fc1"], sh.specs["fc1"], backend)
    y, split = sh.linear(act(y), lp["fc2"], sh.specs["fc2"], backend, x_split=split)
    return sh.full(y, split)


def preprocess_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8/float [N, H, W, 3] -> (x / 255 - 0.5) / 0.5, fused as
    x * (2/255) - 1."""
    return (frames.float() * (2.0 / 255.0) - 1.0).to(dtype)


def forward(params: dict, cfg: SiglipConfig, pixels: torch.Tensor,
            backend: str = "fused", sh=None) -> torch.Tensor:
    """Normalised pixels [N, H, W, 3] -> patch features [N, num_patches, H].
    ``backend``: the kernels of a quantised tower's products
    (``ops.quant.BACKENDS``). ``sh``: the tower's specs on a mesh."""
    pe = params["patch_embed"]
    x = F.conv2d(pixels.permute(0, 3, 1, 2), pe["kernel"].to(pixels.dtype),
                 stride=cfg.patch_size)                     # [N, H, gh, gw]
    N = x.shape[0]
    pos = params["pos_embed"] if sh is None else sh.whole(params["pos_embed"],
                                                          sh.specs["pos_embed"])
    x = x.permute(0, 2, 3, 1) + pe["bias"]
    x = x.reshape(N, cfg.num_patches, cfg.hidden_size) + pos
    lyr = params["layers"]
    lsh = None if sh is None else sh.sub("layers").layer()
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        h = layer_norm(x, lp["ln1"], cfg.layer_norm_eps)
        x = x + _mha(h, lp, cfg.num_heads, backend, lsh)
        h = layer_norm(x, lp["ln2"], cfg.layer_norm_eps)
        x = x + mlp(h, lp, lambda y: F.gelu(y.float(), approximate="tanh").to(x.dtype),
                    backend, lsh)
    return layer_norm(x, params["post_ln"], cfg.layer_norm_eps)


def attention_pool(head: dict, cfg: SiglipConfig, tokens: torch.Tensor,
                   backend: str = "fused") -> torch.Tensor:
    """The MAP probe head (HF's SiglipMultiheadAttentionPoolingHead, the
    reference's ``pooler_output``): post-LN patch tokens [N, P, H] -> [N, H].
    A learned one-token probe attends over the patches, then LN and a
    tanh-GELU MLP with a residual. As in JAX, both products of the attention
    sum in f32 and the probabilities are rounded to the values' dtype before
    the second."""
    N, P, H = tokens.shape
    nh = cfg.num_heads
    d = H // nh
    probe = head["probe"].to(tokens.dtype).expand(N, 1, H)
    q = linear(probe, head["q_proj"], backend).reshape(N, 1, nh, d).transpose(1, 2)
    k, v = (linear(tokens, head[n], backend).reshape(N, P, nh, d).transpose(1, 2)
            for n in ("k_proj", "v_proj"))
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * (1.0 / math.sqrt(d))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.matmul(probs.float(), v.float()).to(tokens.dtype)
    out = linear(out.transpose(1, 2).reshape(N, 1, H), head["out_proj"], backend)
    h = layer_norm(out, head["ln"], cfg.layer_norm_eps)
    h = linear(h, head["fc1"], backend)
    h = F.gelu(h.float(), approximate="tanh").to(tokens.dtype)
    return (out + linear(h, head["fc2"], backend))[:, 0]
