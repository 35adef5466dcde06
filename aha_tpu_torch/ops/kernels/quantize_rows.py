"""The prologues of the quantised products' activations, each a CUDA kernel
of ``csrc/quantize_rows.cu`` beside its plain PyTorch version.

``quantize_rows``: per-token symmetric int8 quantisation, the counterpart of
``aha_tpu/ops/pallas/fused_matmul.py::_quantize_rows`` (the same recipe as
``aha_tpu/ops/quant.py::qlinear_w8a8``), ahead of the ``a8`` variants of
``int8_matmul`` and ``int4_matmul``.

``split_bf16x3``: an f32 x as three bf16 planes hi + mid + lo (== x), ahead
of the f32-activation paths of the same two products on the bf16 tensor
cores, which add the three planes' products into one f32 sum (the TPU
kernel's f32 dot).

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


def split_bf16x3_plain(x: torch.Tensor) -> torch.Tensor:
    """x [..., K] -> planes [3, ..., K] bf16: hi = bf16(x), mid = bf16(x - hi),
    lo = bf16(x - hi - mid), each rounded to nearest even. Each residual is
    exact in f32, and hi + mid + lo == x (three planes hold x's 24 significant
    bits) but where a residual falls below bf16's smallest normal."""
    xf = x.float()
    hi = xf.to(torch.bfloat16)
    r = xf - hi.float()
    mid = r.to(torch.bfloat16)
    lo = (r - mid.float()).to(torch.bfloat16)
    return torch.stack([hi, mid, lo])


def split_bf16x3(x: torch.Tensor) -> torch.Tensor:
    """x [M, K] f32 (contiguous) -> planes [3, M, K] bf16, the kernel on a CUDA
    tensor (counted as ``split_bf16x3``), the plain version on a CPU one."""
    if x.device.type == "cpu":
        return split_bf16x3_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"split_bf16x3: unsupported device {x.device}")
    if x.dim() != 2 or x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"split_bf16x3: x must be contiguous 2-D f32, got "
                         f"{x.dtype} {tuple(x.shape)}")
    M, K = x.shape
    planes = torch.empty((3, M, K), dtype=torch.bfloat16, device=x.device)
    if M == 0 or K == 0:
        return planes
    lib = _build.library()
    err = lib.aha_split_bf16x3(x.data_ptr(), planes.data_ptr(), M, K,
                               ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "split_bf16x3")
    LAUNCHES["split_bf16x3"] += 1
    return planes
