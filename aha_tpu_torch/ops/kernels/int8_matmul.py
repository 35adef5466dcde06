"""``x @ int8 W * scale``: the CUDA kernel ``csrc/int8_matmul.cu`` and its
plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int8_matmul`` with
``a8=False`` (the weight-only product of the --int8 config). A stacked
weight's layer is passed as the view ``qvalue[l]``; no index is needed.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel
launches, or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

launches = 0   # kernel launches so far (the plain version does not count)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int8_matmul_plain(x: torch.Tensor, qvalue: torch.Tensor,
                      scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] @ qvalue [K, N] int8, f32 accumulation, then the
    per-output-channel scale once, cast to x's dtype."""
    y = torch.matmul(x.float(), qvalue.float()) * scale.reshape(-1).float()
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _num_sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


SCALAR, VEC16, TENSOR_CORE = 0, 1, 2   # the kernel's paths (csrc/int8_matmul.cu)


def _path(x2: torch.Tensor, qvalue: torch.Tensor) -> int:
    M, K = x2.shape
    N = qvalue.shape[1]
    if (x2.dtype == torch.bfloat16 and M > 1 and K % 32 == 0 and N % 8 == 0
            and x2.data_ptr() % 16 == 0 and qvalue.data_ptr() % 8 == 0):
        return TENSOR_CORE
    return VEC16 if N % 16 == 0 and qvalue.data_ptr() % 16 == 0 else SCALAR


def _splits(path: int, M: int, K: int, N: int, device: torch.device) -> int:
    """Split K over blocks when the output-tile grid would leave the SMs
    idle; each split keeps at least 256 rows of K."""
    if path == TENSOR_CORE:
        blocks = -(-M // 64) * -(-N // 128)
    else:
        blocks = -(-N // 128) * (1 if M == 1 else -(-M // 4))
    want = -(-2 * _num_sms(device.index or 0) // blocks)
    return max(1, min(want, K // 256, 64))


def int8_matmul(x: torch.Tensor, qvalue: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """x [..., K] (f32 or bf16) @ qvalue [K, N] int8 * scale ([N] or [1, N]
    f32) -> [..., N] in x's dtype."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qvalue, scale)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: unsupported device {x.device}")
    *lead, K = x.shape
    if qvalue.dtype != torch.int8 or qvalue.dim() != 2 or qvalue.shape[0] != K:
        raise ValueError(f"int8_matmul: weight must be int8 [K={K}, N], got "
                         f"{qvalue.dtype} {tuple(qvalue.shape)}")
    N = qvalue.shape[1]
    if scale.dtype != torch.float32 or scale.numel() != N:
        raise ValueError(f"int8_matmul: scale must be f32 with {N} values, got "
                         f"{scale.dtype} {tuple(scale.shape)}")
    if x.dtype not in _DTYPES:
        raise ValueError(f"int8_matmul: x dtype {x.dtype} not supported")
    for name, t in (("x", x), ("qvalue", qvalue), ("scale", scale)):
        if t.device != x.device:
            raise ValueError(f"int8_matmul: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"int8_matmul: {name} must be contiguous")
    x2 = x.reshape(-1, K)
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0:
        return y.reshape(*lead, N)
    if -(-M // 4) > 65535:
        raise ValueError(f"int8_matmul: M={M} exceeds the kernel's grid")
    path = _path(x2, qvalue)
    splits = _splits(path, M, K, N, x.device)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if splits > 1 else None)
    lib = _build.library()
    err = lib.aha_int8_matmul(
        x2.data_ptr(), qvalue.data_ptr(), scale.data_ptr(), y.data_ptr(),
        None if ws is None else ws.data_ptr(), M, K, N, _DTYPES[x.dtype], splits,
        path, ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    _build.check(lib, err, "int8_matmul")
    global launches
    launches += 1
    return y.reshape(*lead, N)
