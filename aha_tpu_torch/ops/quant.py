"""Weight-only int8 kernels at the model's matmul sites.

Counterpart of the int8 half of ``aha_tpu/ops/quant.py``: a quantized kernel
is a dict ``{"qvalue": int8 [K, N], "scale": f32 [1, N]}`` (per output
channel); an embedding table is ``{"qvalue": int8 [V, H], "scale": f32
[V, 1]}`` (per row). ``qlinear`` goes through ``kernels.int8_matmul``, which
launches the CUDA kernel for CUDA tensors and runs its plain version on the
CPU. Packed int4 (``{"q4value", "scale4"}``) is carried by the bridge but
has no compute path yet.
"""

from __future__ import annotations

import torch

from .kernels.int8_matmul import int8_matmul

_INT4_TODO = ("packed-int4 weights have no compute path in aha_tpu_torch yet "
              "(ROADMAP.md, Queue 2: the int4 kernels)")


def dequantize(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    if "q4value" in p:
        raise NotImplementedError(_INT4_TODO)
    return (p["qvalue"].float() * p["scale"]).to(dtype)


def qlinear(x: torch.Tensor, qkernel: dict) -> torch.Tensor:
    """x [..., K] @ an int8 kernel -> [..., N] in x's dtype. A stacked
    kernel's layer l is passed as {k: v[l]}: a view, no copy."""
    if "q4value" in qkernel:
        raise NotImplementedError(_INT4_TODO)
    return int8_matmul(x.contiguous(), qkernel["qvalue"], qkernel["scale"])


def linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    """x @ p["kernel"] (dense [K, N] or int8 dict) + p["bias"] if present:
    the matmul site shared by the tower, the projector and the decoder."""
    k = p["kernel"]
    y = qlinear(x, k) if isinstance(k, dict) else torch.matmul(x, k)
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_rows(table, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Gather embedding rows; an int8 table dequantizes the gathered rows
    with their per-row scales (``qwen2.embed_tokens``)."""
    if isinstance(table, dict):
        if "q4value" in table:
            raise NotImplementedError(_INT4_TODO)
        ids = ids.long()
        return (table["qvalue"][ids].float() * table["scale"][ids]).to(dtype)
    return table[ids.long()]
