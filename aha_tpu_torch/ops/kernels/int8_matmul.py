"""``x @ int8 W * scale``: the CUDA kernel ``csrc/int8_matmul.cu`` and its
plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int8_matmul``: the
weight-only product of the --int8 config (``a8=False``) and its int8-
activation variant (``a8=True``: x quantised per token by
``quantize_rows``, int8 x int8 with int32 accumulation, then the token scale
and the channel scale). ``quant_matmul`` is the named entry for
``aha_tpu/ops/pallas/quant_matmul.py::quant_matmul``, which computes the same
function as ``a8=False`` on an unstacked weight: it launches the same kernel
and keeps a launch count of its own. A stacked weight's layer is passed as
the view ``qvalue[l]``; no index is needed.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, _build
from .quantize_rows import quantize_rows, quantize_rows_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor,
                      a8: bool = False) -> torch.Tensor:
    """x [..., K] @ qvalue [K, N] int8, then the per-output-channel scale
    once, cast to x's dtype. ``a8=False``: f32 accumulation. ``a8=True``:
    x is quantised per row; the int8 x int8 sum is exact (taken in f64,
    where every integer below 2^53 is exact, since neither the CPU nor the
    card multiplies int32 matrices through ``matmul``), rounded to f32 once
    like an int32 accumulator would be, then times the channel scale, then
    times the row scale. The TPU kernel adds its K-block partials in f32
    instead, which is the same number while the sum stays below 2^24."""
    if not a8:
        y = torch.matmul(x.float(), qvalue.float()) * scale.reshape(-1).float()
        return y.to(x.dtype)
    *lead, K = x.shape
    xq, sx = quantize_rows_plain(x.reshape(-1, K))
    acc = torch.matmul(xq.double(), qvalue.double()).float()
    y = acc * scale.reshape(-1).float() * sx
    return y.to(x.dtype).reshape(*lead, qvalue.shape[1])


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


SCALAR, VEC16, TENSOR_CORE = 0, 1, 2   # the kernel's paths (csrc/int8_matmul.cu)


def _path(x2: torch.Tensor, qvalue: torch.Tensor, a8: bool) -> int:
    M, K = x2.shape
    N = qvalue.shape[1]
    if ((a8 or x2.dtype == torch.bfloat16) and M > 1 and K % 32 == 0 and N % 8 == 0
            and x2.data_ptr() % 16 == 0 and qvalue.data_ptr() % 8 == 0):
        return TENSOR_CORE
    return VEC16 if N % 16 == 0 and qvalue.data_ptr() % 16 == 0 else SCALAR


def splits_on(sms: int, blocks: int, units: int) -> int:
    """Split K over blocks when the output-tile grid (``blocks``) would leave
    a card of ``sms`` SMs idle; ``units`` bounds the number of splits (each
    keeps at least one unit of K)."""
    want = -(-2 * sms // blocks)
    return max(1, min(want, units, 64))


def splits_for(blocks: int, units: int, device: torch.device) -> int:
    """``splits_on`` for the card ``device``."""
    return splits_on(num_sms(device.index or 0), blocks, units)


def _launch(name: str, x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor,
            a8: bool) -> torch.Tensor:
    *lead, K = x.shape
    if qvalue.dtype != torch.int8 or qvalue.dim() != 2 or qvalue.shape[0] != K:
        raise ValueError(f"{name}: weight must be int8 [K={K}, N], got "
                         f"{qvalue.dtype} {tuple(qvalue.shape)}")
    N = qvalue.shape[1]
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"{name}: scale must be f32 with {N} values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"{name}: x dtype {x.dtype} not supported")
    for what, t in (("x", x), ("qvalue", qvalue), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"{name}: {what} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if -(-M // 4) > 65535:
        raise ValueError(f"{name}: M={M} exceeds the kernel's grid")
    sx = None
    if a8:
        x2, sx = quantize_rows(x2)
    path = _path(x2, qvalue, a8)
    if path == TENSOR_CORE:
        blocks = -(-M // 64) * -(-N // 128)
    else:
        blocks = -(-N // 128) * (1 if M == 1 else -(-M // 4))
    splits = splits_for(blocks, K // 256, x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    ws_ptr = None if ws is None else ws.data_ptr()
    stream = ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream)
    lib = _build.library()
    if a8:
        err = lib.aha_int8_matmul_a8(
            x2.data_ptr(), sx.data_ptr(), qvalue.data_ptr(), scale.data_ptr(), y.data_ptr(),
            ws_ptr, M, K, N, _DTYPES[x.dtype], splits, path, stream)
    else:
        err = lib.aha_int8_matmul(
            x2.data_ptr(), qvalue.data_ptr(), scale.data_ptr(), y.data_ptr(), ws_ptr,
            M, K, N, _DTYPES[x.dtype], splits, path, stream)
    _build.check(lib, err, name)
    LAUNCHES[name] += 1
    return y.reshape(*lead, N)


def int8_matmul(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor, *,
                a8: bool = False) -> torch.Tensor:
    """x [..., K] (f32 or bf16) @ qvalue [K, N] int8 * scale ([N] or [1, N]
    f32) -> [..., N] in x's dtype; ``a8`` quantises x per token first.
    Counted as ``int8_matmul`` or ``int8_matmul_a8``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qvalue, scale, a8)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    return _launch("int8_matmul_a8" if a8 else "int8_matmul", x, qvalue, scale, a8)


def quant_matmul(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ int8 qvalue [K, N] * scale [1, N] -> [..., N]: the
    weight-only product under the name and signature of the TPU package's
    first int8 kernel. Launches the kernel of ``int8_matmul``; counted as
    ``quant_matmul``."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qvalue, scale)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: unsupported device {x.device}")
    return _launch("quant_matmul", x, qvalue, scale, False)
