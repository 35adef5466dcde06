"""CLIP ViT vision tower over the port's param dict.

Counterpart of ``aha_tpu/models/clip.py`` (``init_params``,
``preprocess_frames``, ``_quick_gelu``, ``forward``): OpenAI-CLIP
normalisation, a CLS token before the patch grid, a pre-LN before the
layers, quick-GELU MLPs and no post-LN on the token stream (the reference
pools ``last_hidden_state[:, 1:]`` and takes ``last_hidden_state[:, 0]`` as
the CLS feature, both un-normalised). The patch conv has no bias; q/k/v/out
and fc1/fc2 all have one. The patch kernel is stored in torch's conv layout
[H, 3, P, P]. As in the SigLIP tower, the products are plain PyTorch on a
dense tower and ``ops.quant.linear``'s int8 kernels on a quantised one
(``--vision_int8``, ``--w8a8``), at the session's ``backend``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import SiglipConfig
from ..ops.quant import linear
from . import jax_random, layer_view
from .siglip import _mha, layer_norm, mlp

# transformers.utils.constants OPENAI_CLIP_MEAN / OPENAI_CLIP_STD
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def init_params(cfg: SiglipConfig, key: tuple[int, int], dtype=torch.float32, device="cuda",
                slab: int = jax_random.SLAB) -> dict:
    """The tree of ``aha_tpu``'s ``clip.init_params(cfg, key, dtype)``: its 16
    keys split from ``key`` (a ``jax_random`` key) and taken in its order,
    kernels and embeddings ``0.02 * normal`` in ``dtype`` drawn in slabs of
    ``slab`` values, norms one, biases zero; the patch kernel in OIHW."""
    ks = iter(jax_random.split(key, 16))

    def dense(shape):
        k = next(ks)
        leaf = torch.empty(shape, dtype=dtype, device=device)
        flat = leaf.view(-1)
        for start in range(0, flat.numel(), slab):
            stop = min(start + slab, flat.numel())
            flat[start:stop] = (0.02 * jax_random.normal(k, shape, start, stop, device)).to(dtype)
        return leaf

    def const(fill, *shape):
        return torch.full(shape, fill, dtype=dtype, device=device)

    L, H, I, P = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size, cfg.patch_size
    cls_embed = dense((H,))
    patch = dense((P, P, 3, H)).permute(3, 2, 0, 1).contiguous()      # HWIO -> OIHW
    pos_embed = dense((cfg.num_patches + 1, H))
    layers = {n: {"kernel": dense((L, H, H)), "bias": const(0.0, L, H)}
              for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    layers["fc1"] = {"kernel": dense((L, H, I)), "bias": const(0.0, L, I)}
    layers["fc2"] = {"kernel": dense((L, I, H)), "bias": const(0.0, L, H)}
    for n in ("ln1", "ln2"):
        layers[n] = {"scale": const(1.0, L, H), "bias": const(0.0, L, H)}
    return {"cls_embed": cls_embed, "patch_embed": {"kernel": patch}, "pos_embed": pos_embed,
            "pre_ln": {"scale": const(1.0, H), "bias": const(0.0, H)}, "layers": layers}


def preprocess_frames(frames: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """uint8/float [N, H, W, 3] -> (x / 255 - mean) / std with CLIP's mean
    and std, computed in f32."""
    mean = torch.tensor(CLIP_MEAN, dtype=torch.float32, device=frames.device)
    std = torch.tensor(CLIP_STD, dtype=torch.float32, device=frames.device)
    x = frames.float() * (1.0 / 255.0)
    return ((x - mean) / std).to(dtype)


def _quick_gelu(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * torch.sigmoid(1.702 * xf)).to(x.dtype)


def forward(params: dict, cfg: SiglipConfig, pixels: torch.Tensor,
            backend: str = "fused", sh=None) -> torch.Tensor:
    """Normalised pixels [N, H, W, 3] -> tokens [N, 1 + num_patches, H], CLS
    first and not post-layernormed (HF's last_hidden_state, which the
    reference slices). ``backend``: the kernels of a quantised tower's
    products (``ops.quant.BACKENDS``). ``sh``: the tower's specs on a mesh."""
    x = F.conv2d(pixels.permute(0, 3, 1, 2), params["patch_embed"]["kernel"].to(pixels.dtype),
                 stride=cfg.patch_size)                       # [N, H, gh, gw]
    N = x.shape[0]
    x = x.permute(0, 2, 3, 1).reshape(N, cfg.num_patches, cfg.hidden_size)
    cls_tok = params["cls_embed"].to(x.dtype).expand(N, 1, cfg.hidden_size)
    pos = params["pos_embed"] if sh is None else sh.whole(params["pos_embed"],
                                                          sh.specs["pos_embed"])
    x = torch.cat([cls_tok, x], dim=1) + pos.to(x.dtype)
    x = layer_norm(x, params["pre_ln"], cfg.layer_norm_eps)
    lyr = params["layers"]
    lsh = None if sh is None else sh.sub("layers").layer()
    for i in range(cfg.num_layers):
        lp = layer_view(lyr, i)
        h = layer_norm(x, lp["ln1"], cfg.layer_norm_eps)
        x = x + _mha(h, lp, cfg.num_heads, backend, lsh)
        h = layer_norm(x, lp["ln2"], cfg.layer_norm_eps)
        x = x + mlp(h, lp, _quick_gelu, backend, lsh)
    return x
