"""Causal attention over a whole sequence with a backward: the CUDA kernels
of ``csrc/flash_attention.cu`` and their plain PyTorch versions.

Counterpart of ``aha_tpu/ops/pallas/flash_attention.py::
flash_causal_attention`` (forward only there; JAX trains through its jnp
attention). ``q`` [B, T, NH, Dh] and ``k``, ``v`` [B, T, KVH, Dh] arrive
rotated; query t sees key u when ``u <= t`` and, where ``key_valid`` [B, T]
bool is given, ``key_valid[b, u]`` (the padding mask of a left-padded batch).
A query that sees no key gives 0, as the Pallas kernel's and
``blockwise_causal_attention``'s guards do (JAX's dense branch gives such a
row the mean of all values instead; only padded rows are affected).

``flash_causal_attention`` is a ``torch.autograd.Function``: the forward
kernel also writes the rows' log-sum-exp (f32 [B, NH, T], -inf for a row that
sees nothing), the backward recomputes the probabilities from it. No sum
crosses blocks out of order and no atomic is used, so a result is the same
from run to run. bf16 with Dh 128 (the 7B) runs on the tensor cores: bf16
operands, f32 sums, the probabilities p and ds = p * (dp - delta) rounded to
bf16 before the second products, and the backward gathers dk / dv per query
head in f32 scratch that this module allocates. f32 storage, and bf16 with Dh
16, run in f32 on the CUDA cores; outputs are cast once. The plain versions
compute in f32 in PyTorch with the [T, T] scores written out, and are what
the Function runs on CPU tensors.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import LAUNCHES, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 128)


def _grouped(x: torch.Tensor, KVH: int) -> torch.Tensor:
    B, T, NH, Dh = x.shape
    return x.float().reshape(B, T, KVH, NH // KVH, Dh)


def _scores_and_mask(q, k, key_valid):
    B, T, NH, Dh = q.shape
    s = torch.einsum("bsgrd,btgd->bgrst", _grouped(q, k.shape[2]), k.float()) / math.sqrt(Dh)
    mask = torch.tril(torch.ones((T, T), dtype=torch.bool, device=q.device))[None, None, None]
    if key_valid is not None:
        mask = mask & key_valid.bool()[:, None, None, None, :]
    return s, mask


def flash_attention_fwd_plain(q, k, v, key_valid=None):
    """-> (o [B, T, NH, Dh] in q's dtype, lse [B, NH, T] f32)."""
    B, T, NH, Dh = q.shape
    s, mask = _scores_and_mask(q, k, key_valid)
    s = s.masked_fill(~mask, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)                       # -inf where a row sees nothing
    p = torch.where(mask, torch.exp(s - torch.nan_to_num(lse, neginf=0.0)[..., None]), 0.0)
    o = torch.einsum("bgrst,btgd->bsgrd", p, v.float())
    return o.reshape(B, T, NH, Dh).to(q.dtype), lse.reshape(B, NH, T)


def flash_causal_attention_plain(q, k, v, key_valid=None) -> torch.Tensor:
    return flash_attention_fwd_plain(q, k, v, key_valid)[0]


def flash_causal_attention_bwd_plain(q, k, v, o, dout, lse, key_valid=None):
    """The closed-form backward: -> (dq, dk, dv) in the inputs' dtypes."""
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    scale = 1.0 / math.sqrt(Dh)
    s, mask = _scores_and_mask(q, k, key_valid)
    lse_g = lse.reshape(B, KVH, NH // KVH, T)
    p = torch.where(mask, torch.exp(s - torch.nan_to_num(lse_g, neginf=0.0)[..., None]), 0.0)
    dog = _grouped(dout, KVH)
    delta = (dog * _grouped(o, KVH)).sum(-1).permute(0, 2, 3, 1)        # [B, KVH, rep, T]
    ds = p * (torch.einsum("bsgrd,btgd->bgrst", dog, v.float()) - delta[..., None])
    dq = torch.einsum("bgrst,btgd->bsgrd", ds, k.float()) * scale
    dk = torch.einsum("bgrst,bsgrd->btgd", ds, _grouped(q, KVH)) * scale
    dv = torch.einsum("bgrst,bsgrd->btgd", p, dog)
    return dq.reshape(B, T, NH, Dh).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(name, q, k, v, key_valid, more=()):
    """Raise on what the kernels do not take; -> (B, T, NH, KVH, Dh)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B, T, NH, Dh] and k, v [B, T, KVH, Dh] expected, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, T, NH, Dh = q.shape
    KVH = k.shape[2]
    if k.shape[0] != B or k.shape[1] != T or k.shape[3] != Dh or KVH == 0 or NH % KVH:
        raise ValueError(f"{name}: k {tuple(k.shape)} does not match q {tuple(q.shape)}")
    if Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {Dh} not supported (one of {HEAD_DIMS})")
    if q.dtype not in _DTYPES:
        raise ValueError(f"{name}: dtype {q.dtype} not supported")
    if B > 65535 or KVH > 65535 or B * T * NH * Dh >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(q.shape)} exceeds the kernel's grid")
    for what, t in (("q", q), ("k", k), ("v", v), *more):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype} on {t.device}, q {q.dtype} on "
                             f"{q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {what} must be contiguous and 16-byte aligned")
    if key_valid is not None and (key_valid.dtype != torch.bool or key_valid.shape != (B, T)
                                  or key_valid.device != q.device
                                  or not key_valid.is_contiguous()):
        raise ValueError(f"{name}: key_valid must be a contiguous bool [B={B}, T={T}] on "
                         f"{q.device}")
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")
    return B, T, NH, KVH, Dh


def flash_attention_fwd(q, k, v, key_valid=None):
    """-> (o, lse). Counted as ``flash_attention_fwd``."""
    if q.device.type == "cpu":
        return flash_attention_fwd_plain(q, k, v, key_valid)
    B, T, NH, KVH, Dh = _check("flash_attention_fwd", q, k, v, key_valid)
    o = torch.empty_like(q)
    lse = torch.empty((B, NH, T), dtype=torch.float32, device=q.device)
    if q.numel() == 0:
        return o, lse
    lib = _build.library()
    err = lib.aha_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), o.data_ptr(), lse.data_ptr(),
        B, T, NH, KVH, Dh, _DTYPES[q.dtype], 1.0 / math.sqrt(Dh),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, err, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bwd(q, k, v, o, dout, lse, key_valid=None):
    """-> (dq, dk, dv). Counted as ``flash_attention_bwd`` (one count for its
    launches: delta, dq, dk and dv, and on the tensor-core path the sum of the
    query heads' partial dk / dv)."""
    if q.device.type == "cpu":
        return flash_causal_attention_bwd_plain(q, k, v, o, dout, lse, key_valid)
    B, T, NH, KVH, Dh = _check("flash_attention_bwd", q, k, v, key_valid,
                               more=(("o", o), ("dout", dout)))
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and dout "
                         f"{tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    if (lse.dtype != torch.float32 or lse.shape != (B, NH, T) or lse.device != q.device
            or not lse.is_contiguous()):
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous f32 [B, NH, T] on "
                         f"{q.device}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk, dv
    delta = torch.empty_like(lse)
    lib = _build.library()
    # the tensor-core path's f32 partial dk / dv per query head; nothing for the f32 path
    nbytes = lib.aha_flash_attention_bwd_scratch_bytes(B, T, NH, Dh, _DTYPES[q.dtype])
    scratch = torch.empty((nbytes,), dtype=torch.uint8, device=q.device) if nbytes else None
    err = lib.aha_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if key_valid is None else key_valid.data_ptr(), o.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), None if scratch is None else scratch.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, NH, KVH, Dh, _DTYPES[q.dtype], 1.0 / math.sqrt(Dh),
        ctypes.c_void_p(torch.cuda.current_stream(q.device).cuda_stream))
    _build.check(lib, err, "flash_attention_bwd")
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class _FlashCausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, key_valid):
        o, lse = flash_attention_fwd(q, k, v, key_valid)
        ctx.save_for_backward(q, k, v, o, lse, key_valid)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse, key_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, dout.contiguous(), lse, key_valid)
        return dq, dk, dv, None


def flash_causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           key_valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rotated q [B, T, NH, Dh], k / v [B, T, KVH, Dh] (f32 or bf16, Dh 16 or
    128, contiguous), optional key_valid [B, T] bool -> [B, T, NH, Dh].
    Differentiable in q, k and v."""
    return _FlashCausalAttention.apply(q, k, v, key_valid)
