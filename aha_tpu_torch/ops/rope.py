"""Rotary position embeddings (llama/qwen convention, rotate-half).

Counterpart of ``aha_tpu/ops/rope.py``: the same split of a position into
``hi * 8192 + lo`` before it meets the inverse frequencies, so that absolute
stream positions far past 8192 keep their angle (the ``hi`` table is folded
modulo 2*pi in float64 on the host). Below 8192 the result is the plain
``pos * inv_freq`` product.
"""

from __future__ import annotations

import numpy as np
import torch

_POS_SPLIT = 8192


def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float,
                 dtype=torch.float32) -> tuple[torch.Tensor, torch.Tensor]:
    """Integer positions [...] -> (cos, sin), each [..., head_dim], with the
    frequencies repeated over both halves."""
    half = head_dim // 2
    inv_freq_64 = 1.0 / (theta ** (np.arange(0, half, dtype=np.float64) / half))
    dev = positions.device
    inv_freq = torch.as_tensor(inv_freq_64.astype(np.float32), device=dev)
    hi_freq = torch.as_tensor(
        np.mod(_POS_SPLIT * inv_freq_64, 2 * np.pi).astype(np.float32), device=dev)
    pos = positions.long()[..., None]
    hi = torch.div(pos, _POS_SPLIT, rounding_mode="floor").float()
    lo = torch.remainder(pos, _POS_SPLIT).float()
    freqs = hi * hi_freq + lo * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos().to(dtype), emb.sin().to(dtype)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x [..., S, H, D] by cos/sin [..., S, D] (broadcast over heads)."""
    cos = cos[..., :, None, :]
    sin = sin[..., :, None, :]
    return (x * cos + rotate_half(x) * sin).to(x.dtype)


def rotate_by_positions(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate x [..., S, H, D] by integer positions [..., S]."""
    cos, sin = rope_cos_sin(positions, x.shape[-1], theta)
    return apply_rope(x.float(), cos, sin).to(x.dtype)
