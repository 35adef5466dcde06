"""Device-side letterbox: aspect-preserving bilinear resize + centred zero pad.

Counterpart of ``aha_tpu/ops/preprocess.py::device_letterbox``, which calls
``jax.image.resize(method="linear", antialias=False)``: half-pixel bilinear,
where a sample's weights over the input pixels are the triangle kernel,
renormalised at the border. The same per-axis weight matrices are built
here (in f32, as jax does) and applied as two matmuls.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def letterbox_params(h: int, w: int, output_size: int) -> tuple[int, int, int, int]:
    """(new_h, new_w, top, left): the placement of
    ``aha_tpu/data/media.py::letterbox_params`` (the port imports nothing of
    that package and keeps its own copy)."""
    if w > h:
        new_w, new_h = output_size, int((h / w) * output_size)
    else:
        new_h, new_w = output_size, int((w / h) * output_size)
    return new_h, new_w, (output_size - new_h) // 2, (output_size - new_w) // 2


@functools.lru_cache(maxsize=None)
def _linear_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in, out] f32 weights of half-pixel linear resampling."""
    f32 = np.float32
    inv_scale = f32(1.0) / f32(f32(out_size) / f32(in_size))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(f32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def device_letterbox(frames: torch.Tensor, output_size: int,
                     dtype=torch.float32) -> torch.Tensor:
    """[N, H, W, 3] pixels (uint8 or float) -> [N, S, S, 3] letterboxed
    pixel values, still in 0..255."""
    N, H, W, _ = frames.shape
    if (H, W) == (output_size, output_size):
        return frames.to(dtype)
    new_h, new_w, top, left = letterbox_params(H, W, output_size)
    dev = frames.device
    wh = torch.as_tensor(_linear_weights(H, new_h), device=dev)
    ww = torch.as_tensor(_linear_weights(W, new_w), device=dev)
    x = torch.einsum("nhwc,hp->npwc", frames.float(), wh)
    x = torch.einsum("npwc,wq->npqc", x, ww)
    x = x.clamp(0.0, 255.0)
    out = torch.zeros((N, output_size, output_size, 3), dtype=torch.float32, device=dev)
    out[:, top:top + new_h, left:left + new_w] = x
    return out.to(dtype)
