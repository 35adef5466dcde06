"""Per-token symmetric int8 quantisation of activations: the CUDA kernel
``csrc/quantize_rows.cu`` and its plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::_quantize_rows`` (the
same recipe as ``aha_tpu/ops/quant.py::qlinear_w8a8``): the prologue of the
``a8`` variants of ``int8_matmul`` and ``int4_matmul``.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import LAUNCHES, _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def quantize_rows_plain(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] -> (xq int8 [M, K], sx f32 [M, 1]): sx = max(absmax / 127,
    1e-12) per row, xq = clip(round(x / sx), -127, 127), rounding half to
    even, all in f32."""
    xf = x.float()
    # a tensor divisor: PyTorch turns a division by a Python scalar into a
    # multiplication by its reciprocal on the card, which can move the last
    # bit of the scale
    sx = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / xf.new_tensor(127.0), min=1e-12)
    xq = torch.clamp(torch.round(xf / sx), -127, 127).to(torch.int8)
    return xq, sx


def quantize_rows(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x [M, K] (f32 or bf16, contiguous) -> (xq int8 [M, K], sx f32 [M, 1])."""
    if x.device.type == "cpu":
        return quantize_rows_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"quantize_rows: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype not in _DTYPES or not x.is_contiguous():
        raise ValueError(f"quantize_rows: x must be contiguous 2-D f32 or bf16, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    xq = torch.empty((M, K), dtype=torch.int8, device=x.device)
    sx = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0 or K == 0:
        return xq, sx
    lib = _build.library()
    err = lib.aha_quantize_rows(
        x.data_ptr(), xq.data_ptr(), sx.data_ptr(), M, K, _DTYPES[x.dtype],
        ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "quantize_rows")
    LAUNCHES["quantize_rows"] += 1
    return xq, sx
