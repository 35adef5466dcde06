"""Remat ``dots`` and ``dots_no_batch``: a decoder layer replayed in the
backward with the outputs of its products kept from the forward.

Counterpart of the two ``jax.checkpoint`` policies of
``aha_tpu/models/qwen2.py::forward_hidden`` (``checkpoint_dots``,
``checkpoint_dots_with_no_batch_dims``). torch's selective-checkpoint policies
name aten ops, and the products here are CUDA kernels launched through
``ctypes`` inside autograd Functions, which those policies never see. So the
split is made by hand: the layer runs under ``torch.utils.checkpoint``
(non-reentrant), and each product site goes through a ``ProductStash``. In the
forward the stash computes the product and keeps its output; in the replay
that the checkpoint runs in the backward it hands the kept output back without
computing anything, so only the elementwise work (norms, rotations, SiLU x up,
the adapters' dropout and scale, casts, biases, residuals) is done again. Each
product is an autograd Function that saves the same operands in both passes
and whose backward is the product's own: the transposed kernel for int4, the
dequantised transposed product for int8, ``g @ b^T`` and ``a^T @ g`` for a
dense or adapter product, the flash backward for attention.

``dots_no_batch`` keeps the products without dot-general batch dimensions:
the projections and the adapters' low-rank products. ``dots`` also keeps the
attention (the flash forward's output and log-sum-exp), which JAX computes as
batched einsums at the collator's lengths.
"""

from __future__ import annotations

import torch

from ..ops.kernels.flash_attention import flash_attention_bwd, flash_attention_fwd
from ..ops.kernels.int4_matmul import int4_matmul
from ..ops.kernels.int8_matmul import int8_matmul, int8_qlinear_vjp

POLICIES = ("dots", "dots_no_batch")


class ProductStash:
    """The outputs of one layer's products, in call order: computed and kept
    until ``replay()``, handed back one by one after it."""

    def __init__(self, attention: bool):
        self.attention = attention      # keep the attention too ("dots")
        self.outs: list = []
        self.pos: int | None = None

    def replay(self) -> None:
        self.pos = 0

    def take(self, compute):
        if self.pos is None:
            out = compute()
            # aliases without autograd history: the replay's Function adopts them
            self.outs.append(tuple(t.detach() for t in out) if isinstance(out, tuple)
                             else out.detach())
            return out
        out = self.outs[self.pos]
        self.pos += 1
        return out

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a [..., K] @ b [K, N], operands of one dtype."""
        return _KeptMatmul.apply(self, a, b)

    def linear(self, x: torch.Tensor, p: dict, backend: str) -> torch.Tensor:
        """``ops.quant.linear`` with the product kept: a frozen int4 or int8
        kernel on the ``"fused"`` kernels, or a dense kernel (promoted with x as
        ``linear`` does); the bias is added after."""
        k = p["kernel"]
        if isinstance(k, dict):
            if backend != "fused":
                raise ValueError(f"remat 'dots': the {backend!r} backend has no gradient; "
                                 "train with backend='fused'")
            if "q4value" in k:
                y = _KeptQuant.apply(self, "int4", x.contiguous(), k["q4value"], k["scale4"])
            else:
                y = _KeptQuant.apply(self, "int8", x.contiguous(), k["qvalue"], k["scale"])
        else:
            dt = torch.promote_types(x.dtype, k.dtype)
            y = self.matmul(x.to(dt), k.to(dt))
        return y + p["bias"] if "bias" in p else y

    def attend(self, q, k, v, key_valid):
        """Rotated q, k, v -> attention [B, T, NH, Dh], kept ("dots" only:
        under "dots_no_batch" the layer attends as it does unstashed)."""
        return _KeptFlash.apply(self, q, k, v, key_valid)


class _KeptMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stash, a, b):
        ctx.save_for_backward(a, b)
        return stash.take(lambda: torch.matmul(a, b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        da = db = None
        if ctx.needs_input_grad[1]:
            da = torch.matmul(g, b.t())
        if ctx.needs_input_grad[2]:
            db = a.reshape(-1, a.shape[-1]).t() @ g.reshape(-1, g.shape[-1])
        return None, da, db


class _KeptQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stash, kind, x, w, scale):
        ctx.kind = kind
        ctx.save_for_backward(w, scale)
        if kind == "int4":
            return stash.take(lambda: int4_matmul(x, w, scale))
        return stash.take(lambda: int8_matmul(x, w, scale))

    @staticmethod
    def backward(ctx, g):
        w, scale = ctx.saved_tensors
        if ctx.kind == "int4":
            from ..ops.kernels.int4_matmul_t import int4_matmul_t

            return None, None, int4_matmul_t(g.contiguous(), w, scale), None, None
        return None, None, int8_qlinear_vjp(g, w, scale), None, None


class _KeptFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stash, q, k, v, key_valid):
        o, lse = stash.take(lambda: flash_attention_fwd(q, k, v, key_valid))
        ctx.save_for_backward(q, k, v, o, lse, key_valid)
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse, key_valid = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, o, dout.contiguous(), lse, key_valid)
        return None, dq, dk, dv, None
