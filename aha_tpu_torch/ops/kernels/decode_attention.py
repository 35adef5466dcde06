"""Cached GQA attention over the ring-buffer cache: the CUDA kernel
``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/decode_attention.py::
cached_decode_attention``, with the same contract: ``q_rot`` is already
rotated at the chunk's write positions; each cached key gets a further
per-slot rotation by (cos, sin); a slot is visible to query s iff
``order >= 0 & order <= g[s]``; in int8 KV mode the per-(slot, head) scales
fold into the score and probability columns.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..rope import rotate_half
from . import _build

launches = 0   # kernel launches so far (the plain version does not count)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
HEAD_DIMS = (16, 32, 64, 128)


def decode_attention_plain(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None):
    """q_rot [B, S, NH, Dh]; k/v cache [B, Wp, KVH, Dh]; cos/sin [B, Wp, Dh]
    f32; order [B, Wp] int32; g [B, S] int32; kv_scales (k_scale, v_scale)
    [B, Wp, KVH] f32 for an int8 cache. Returns [B, S, NH, Dh] in q's dtype;
    a row that sees no slot gets zeros. All math in f32."""
    B, S, NH, Dh = q_rot.shape
    KVH = k_cache.shape[2]
    kf = k_cache.float()
    k_rot = kf * cos[:, :, None, :] + rotate_half(kf) * sin[:, :, None, :]
    qg = q_rot.float().reshape(B, S, KVH, NH // KVH, Dh)
    s = torch.einsum("bsgrd,bwgd->bgrsw", qg, k_rot) * (1.0 / math.sqrt(Dh))
    if kv_scales is not None:
        s = s * kv_scales[0].float().transpose(1, 2)[:, :, None, None, :]
    order = order[:, None, :]
    mask = ((order >= 0) & (order <= g[:, :, None]))[:, None, None]   # [B,1,1,S,Wp]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m)
    l = p.sum(dim=-1)                                                  # [B,KVH,rep,S]
    if kv_scales is not None:
        p = p * kv_scales[1].float().transpose(1, 2)[:, :, None, None, :]
    o = torch.einsum("bgrsw,bwgd->bsgrd", p, v_cache.float())
    o = o / torch.clamp(l, min=1e-30).permute(0, 3, 1, 2)[..., None]
    return o.reshape(B, S, NH, Dh).to(q_rot.dtype)


def _check(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales):
    if q_rot.dim() != 4 or k_cache.dim() != 4:
        raise ValueError("decode_attention: q_rot and the cache must be 4-D")
    B, S, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    if Dh not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head_dim {Dh} not in {HEAD_DIMS}")
    if q_rot.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"decode_attention: q dtype {q_rot.dtype} not supported")
    if k_cache.dtype not in (q_rot.dtype, torch.int8) or v_cache.dtype != k_cache.dtype:
        raise ValueError(f"decode_attention: cache dtype {k_cache.dtype} with q "
                         f"{q_rot.dtype} not supported")
    if (k_cache.dtype == torch.int8) != (kv_scales is not None):
        raise ValueError("decode_attention: kv_scales go with an int8 cache, and only there")
    if NH % KVH:
        raise ValueError(f"decode_attention: {NH} heads over {KVH} kv heads")
    want = {
        "k_cache": (k_cache, (B, Wp, KVH, Dh), None),
        "v_cache": (v_cache, (B, Wp, KVH, Dh), None),
        "cos": (cos, (B, Wp, Dh), torch.float32),
        "sin": (sin, (B, Wp, Dh), torch.float32),
        "order": (order, (B, Wp), torch.int32),
        "g": (g, (B, S), torch.int32),
        "q_rot": (q_rot, (B, S, NH, Dh), None),
    }
    if kv_scales is not None:
        want["k_scale"] = (kv_scales[0], (B, Wp, KVH), torch.float32)
        want["v_scale"] = (kv_scales[1], (B, Wp, KVH), torch.float32)
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_attention: {name} shape {tuple(t.shape)} != {shape}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"decode_attention: {name} dtype {t.dtype} != {dtype}")
        if t.device != q_rot.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, q on {q_rot.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous")
        if t.data_ptr() % (4 * t.element_size()):
            raise ValueError(f"decode_attention: {name} must start 4-element aligned")


def decode_attention(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales=None):
    """Same contract as ``decode_attention_plain``."""
    if q_rot.device.type == "cpu":
        return decode_attention_plain(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales)
    if q_rot.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q_rot.device}")
    _check(q_rot, k_cache, v_cache, cos, sin, order, g, kv_scales)
    B, S, NH, Dh = q_rot.shape
    Wp, KVH = k_cache.shape[1], k_cache.shape[2]
    out = torch.empty_like(q_rot)
    ks, vs = (None, None) if kv_scales is None else (kv_scales[0].data_ptr(),
                                                     kv_scales[1].data_ptr())
    lib = _build.library()
    err = lib.aha_decode_attention(
        q_rot.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), cos.data_ptr(),
        sin.data_ptr(), order.data_ptr(), g.data_ptr(), ks, vs, out.data_ptr(),
        B, S, NH, KVH, Dh, Wp, _DTYPES[q_rot.dtype], _DTYPES[k_cache.dtype],
        1.0 / math.sqrt(Dh),
        ctypes.c_void_p(torch.cuda.current_stream(q_rot.device).cuda_stream))
    _build.check(lib, err, "decode_attention")
    global launches
    launches += 1
    return out
