"""``x @`` packed-int4 ``W`` with group scales: the CUDA kernel
``csrc/int4_matmul.cu`` and its plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int4_matmul``: the
product behind every decoder projection, the projector and the lm_head of
the --int4 config, weight-only (``a8=False``) or with per-token int8
activations (``a8=True``). ``q4value`` [K/2, N] uint8 packs row 2j in the low
nibble and row 2j + 1 in the high nibble of byte j, values offset by 8;
``scale4`` [K/G, N] bf16 holds one scale per group of G rows and output
column (G = K // scale4.shape[0]). A stacked weight's layer is passed as the
views ``q4value[l]``, ``scale4[l]``. ``int4_qlinear`` is the same product
with a gradient for ``x`` (``aha_tpu/ops/pallas/fused_matmul.py::
int4_qlinear``): forward this kernel, backward ``int4_matmul_t``, nothing for
the frozen weight and scales.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build
from .int8_matmul import SCALAR, TENSOR_CORE, VEC16, splits_for
from .quantize_rows import quantize_rows, quantize_rows_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def unpack_int4(q4value: torch.Tensor) -> torch.Tensor:
    """[..., K/2, N] uint8 -> [..., K, N] int8 in -8..7 (low nibble = even
    row, high nibble = odd row)."""
    *lead, Kh, N = q4value.shape
    low = (q4value & 0xF).to(torch.int8) - 8
    high = (q4value >> 4).to(torch.int8) - 8
    return torch.stack([low, high], dim=-2).reshape(*lead, 2 * Kh, N)


def int4_matmul_plain(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor,
                      a8: bool = False) -> torch.Tensor:
    """Rounds where the kernel rounds: a group's partial sum in f32
    (``a8``: exact integers, taken in f64 and rounded to f32 once, as an
    int32 accumulator converts), times the group's bf16 scale as f32, the
    groups added in f32, (``a8``: times the row scale,) one cast at the end."""
    *lead, K = x.shape
    Kh, N = q4value.shape
    n_groups = scale4.shape[0]
    G = K // n_groups
    x2 = x.reshape(-1, K)
    w = unpack_int4(q4value).reshape(n_groups, G, N)
    if a8:
        xq, sx = quantize_rows_plain(x2)
        part = torch.einsum("mgk,gkn->mgn", xq.double().reshape(-1, n_groups, G),
                            w.double()).float()
    else:
        part = torch.einsum("mgk,gkn->mgn", x2.float().reshape(-1, n_groups, G), w.float())
    y = (part * scale4.float()[None]).sum(dim=1)
    if a8:
        y = y * sx
    return y.to(x.dtype).reshape(*lead, N)


def _path(x2: torch.Tensor, q4value: torch.Tensor, G: int, a8: bool) -> int:
    M = x2.shape[0]
    N = q4value.shape[1]
    if ((a8 or x2.dtype == torch.bfloat16) and M > 1 and G % 32 == 0 and N % 8 == 0
            and x2.data_ptr() % 16 == 0 and q4value.data_ptr() % 8 == 0):
        return TENSOR_CORE
    return VEC16 if N % 16 == 0 and q4value.data_ptr() % 16 == 0 else SCALAR


def int4_matmul(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor, *,
                a8: bool = False) -> torch.Tensor:
    """x [..., K] (f32 or bf16) @ packed q4value [K/2, N] uint8 with group
    scales scale4 [K/G, N] bf16 -> [..., N] in x's dtype. Any M, any N, K
    even, K % G == 0 and G even. Counted as ``int4_matmul`` or
    ``int4_matmul_a8``."""
    if x.device.type == "cpu":
        return int4_matmul_plain(x, q4value, scale4, a8)
    if x.device.type != "cuda":
        raise ValueError(f"int4_matmul: unsupported device {x.device}")
    *lead, K = x.shape
    if (q4value.dtype != torch.uint8 or q4value.dim() != 2 or K % 2
            or q4value.shape[0] * 2 != K):
        raise ValueError(f"int4_matmul: weight must be uint8 [K/2={K // 2}, N], got "
                         f"{q4value.dtype} {tuple(q4value.shape)}")
    N = q4value.shape[1]
    if (scale4.dtype != torch.bfloat16 or scale4.dim() != 2 or scale4.shape[1] != N
            or scale4.shape[0] == 0 or K % scale4.shape[0]):
        raise ValueError(f"int4_matmul: scale4 must be bf16 [K/G, N={N}], got "
                         f"{scale4.dtype} {tuple(scale4.shape)}")
    G = K // scale4.shape[0]
    if G % 2:
        raise ValueError(f"int4_matmul: group size {G} must be even")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"int4_matmul: x dtype {x.dtype} not supported")
    for what, t in (("x", x), ("q4value", q4value), ("scale4", scale4)):
        if t.device != x.device:
            raise ValueError(f"int4_matmul: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul: {what} must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if -(-M // 2) > 65535:
        raise ValueError(f"int4_matmul: M={M} exceeds the kernel's grid")
    sx = None
    if a8:
        x2, sx = quantize_rows(x2)
    path = _path(x2, q4value, G, a8)
    if path == TENSOR_CORE:
        splits = splits_for(-(-M // 64) * -(-N // 128), K // 256, x.device)
    else:
        # whole groups per split, four groups in flight per block
        splits = splits_for(-(-N // 128) * -(-M // 2), (K // G) // 4, x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _build.library()
    err = lib.aha_int4_matmul(
        x2.data_ptr(), None if sx is None else sx.data_ptr(), q4value.data_ptr(),
        scale4.data_ptr(), y.data_ptr(), None if ws is None else ws.data_ptr(),
        M, K, N, G, _DTYPES[x2.dtype], _DTYPES[x.dtype], splits, path,
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "int4_matmul")
    LAUNCHES["int4_matmul_a8" if a8 else "int4_matmul"] += 1
    return y.reshape(*lead, N)


class _Int4QLinear(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, q4value, scale4):
        ctx.save_for_backward(q4value, scale4)
        return int4_matmul(x, q4value, scale4)

    @staticmethod
    def backward(ctx, grad):
        from .int4_matmul_t import int4_matmul_t   # it imports unpack_int4 from here

        q4value, scale4 = ctx.saved_tensors
        return int4_matmul_t(grad.contiguous(), q4value, scale4), None, None


def int4_qlinear(x: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """``int4_matmul(x, q4value, scale4)`` (weight-only) that autograd can
    differentiate with respect to ``x``: the backward launches
    ``int4_matmul_t`` on the incoming gradient. The packed weight and its
    scales are frozen and get no gradient."""
    return _Int4QLinear.apply(x, q4value, scale4)
