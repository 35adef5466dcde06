"""Quantized weights at the model's matmul sites: int8 per channel and
packed int4 per group.

Counterpart of ``aha_tpu/ops/quant.py``. A quantized kernel is a dict:

  * ``{"qvalue": int8 [K, N], "scale": f32 [1, N]}``: per output channel;
  * ``{"q4value": uint8 [K/2, N], "scale4": bf16 [K/G, N]}``: packed int4,
    row 2j in the low nibble and row 2j + 1 in the high nibble of byte j,
    values offset by 8, one scale per group of G = K // scale4.shape[-2]
    rows and output column (G is K itself where 128 does not divide K).

An embedding table is ``{"qvalue": int8 [V, H], "scale": f32 [V, 1]}`` (per
row) under either mode.

``qlinear`` takes the matmul backend as a plain argument, handed down from
``build_session`` / ``StreamEngine`` (no environment variable, no module
global):

  * ``"fused"`` (default): the weight-only kernels ``int8_matmul`` /
    ``int4_matmul``;
  * ``"fused_a8"``: the same kernels with per-token int8 activations (the
    W8A8 / W4A8 recipe);
  * ``"pallas"``: ``quant_matmul``, the named entry for the TPU package's
    first int8 kernel; int8 weights only.

Each wrapper launches its CUDA kernel for CUDA tensors and runs its plain
version on the CPU.

Under autograd (``x`` requires a gradient, as every activation behind a
trained adapter or projector does) packed int4 under ``"fused"`` goes through
``int4_qlinear``, whose backward is the ``int4_matmul_t`` kernel: that is what
makes a frozen int4 trunk trainable. Without a gradient to carry the plain
wrapper is called, so the serving path pays for no autograd node. The
int8-activation recipe is not differentiable (nor is it in the TPU package),
and int8 weights under a gradient are not ported yet: both raise.
"""

from __future__ import annotations

import torch

from .kernels.int4_matmul import int4_matmul, int4_qlinear, unpack_int4
from .kernels.int8_matmul import int8_matmul, quant_matmul

BACKENDS = ("fused", "fused_a8", "pallas")


def dequantize_int4(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    """{q4value [..., K/2, N], scale4 [..., K/G, N]} -> dense [..., K, N]."""
    q = unpack_int4(p["q4value"]).float()
    *lead, K, N = q.shape
    scale = p["scale4"].float()
    n_groups = scale.shape[-2]
    q = q.reshape(*lead, n_groups, K // n_groups, N) * scale[..., :, None, :]
    return q.reshape(*lead, K, N).to(dtype)


def dequantize(p: dict, dtype=torch.bfloat16) -> torch.Tensor:
    if "q4value" in p:
        return dequantize_int4(p, dtype)
    return (p["qvalue"].float() * p["scale"]).to(dtype)


def qlinear(x: torch.Tensor, qkernel: dict, backend: str = "fused") -> torch.Tensor:
    """x [..., K] @ a quantized kernel -> [..., N] in x's dtype. A stacked
    kernel's layer l is passed as {k: v[l]}: views, no copy."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown matmul backend {backend!r}; one of {BACKENDS}")
    x = x.contiguous()
    under_grad = torch.is_grad_enabled() and x.requires_grad
    if under_grad and backend == "fused_a8":
        raise ValueError("the 'fused_a8' backend quantises the activations and has no "
                         "gradient; train with backend='fused'")
    if under_grad and "q4value" not in qkernel:
        raise NotImplementedError(
            "training through int8 weights is not ported yet (ROADMAP.md, Queue 1 item 6: "
            "int8-trunk training); quantise the trunk to packed int4")
    if "q4value" in qkernel:
        if backend == "pallas":
            raise ValueError("the 'pallas' backend (quant_matmul) takes int8 weights only")
        if under_grad:
            return int4_qlinear(x, qkernel["q4value"], qkernel["scale4"])
        return int4_matmul(x, qkernel["q4value"], qkernel["scale4"],
                           a8=backend == "fused_a8")
    if backend == "pallas":
        return quant_matmul(x, qkernel["qvalue"], qkernel["scale"])
    return int8_matmul(x, qkernel["qvalue"], qkernel["scale"], a8=backend == "fused_a8")


def linear(x: torch.Tensor, p: dict, backend: str = "fused") -> torch.Tensor:
    """x @ p["kernel"] (dense [K, N] or a quantized dict) + p["bias"] if
    present: the matmul site shared by the tower, the projector and the
    decoder."""
    k = p["kernel"]
    y = qlinear(x, k, backend) if isinstance(k, dict) else torch.matmul(x, k)
    if "bias" in p:
        y = y + p["bias"]
    return y


def embed_rows(table, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Gather embedding rows; an int8 table dequantizes the gathered rows
    with their per-row scales (``qwen2.embed_tokens``)."""
    if isinstance(table, dict):
        ids = ids.long()
        return (table["qvalue"][ids].float() * table["scale"][ids]).to(dtype)
    return table[ids.long()]
