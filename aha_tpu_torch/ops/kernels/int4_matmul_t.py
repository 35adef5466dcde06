"""``g @ W^T`` for a packed-int4 ``W`` with group scales: the CUDA kernel
``csrc/int4_matmul_t.cu`` and its plain PyTorch version.

Counterpart of ``aha_tpu/ops/pallas/fused_matmul.py::int4_matmul_t``: the
gradient with respect to the activations of a frozen int4 projection,
``dx[m, k] = sum_n g[m, n] * scale4[k // G, n] * w[k, n]``, which is all the
backward a QLoRA trunk needs (``int4_matmul.int4_qlinear`` wires it in). The
weight layouts are ``int4_matmul``'s: ``q4value`` [K/2, N] uint8 with row 2j in
the low and row 2j + 1 in the high nibble of byte j, ``scale4`` [K/G, N] bf16.
``dx`` comes back with its K columns in order: no even / odd planes.

On a CPU tensor the plain version runs; on a CUDA tensor the kernel launches,
or the call raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import LAUNCHES, _build
from .int4_matmul import WGMMA, Plan, token_tile, unpack_int4
from .int8_matmul import TENSOR_CORE

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def int4_matmul_t_plain(g: torch.Tensor, q4value: torch.Tensor,
                        scale4: torch.Tensor) -> torch.Tensor:
    """Rounds where the kernel rounds: the dequantised weight
    ``scale * (nibble - 8)`` in g's dtype (exact in f32, one rounding in
    bf16), products and sums in f32, one cast at the end."""
    *lead, N = g.shape
    w = unpack_int4(q4value).float()                        # [K, N]
    K = w.shape[0]
    n_groups = scale4.shape[0]
    w = (w.reshape(n_groups, K // n_groups, N) * scale4.float()[:, None, :]).reshape(K, N)
    w = w.to(g.dtype).float()
    return (g.reshape(-1, N).float() @ w.t()).to(g.dtype).reshape(*lead, K)


def row_to_column(row: int) -> int:
    """Which column of dx accumulator row ``row`` of the wgmma kernel is. In
    each slab of 64 rows a thread's operand registers hold rows gid and gid + 8
    of its warp's 16, and it fills them with the low and the high nibbles of
    packed row 8 w + gid: dx columns 16 w + 2 gid and 16 w + 2 gid + 1."""
    slab, r = divmod(row, 64)
    w, q = divmod(r, 16)
    return 64 * slab + 16 * w + 2 * (q % 8) + q // 8


@functools.lru_cache(maxsize=None)
def plan(M: int, K: int, N: int, G: int, *, bf16: bool, aligned: bool = True) -> Plan:
    """The launch of ``int4_matmul_t`` for g [M, N], q4value [K/2, N], scale4
    [K/G, N] (``aligned``: all three start on 16 bytes). Pure: no card is asked."""
    if bf16 and aligned and G % 64 == 0 and N % 64 == 0:
        tile, tiles = token_tile(M, 128)
        stages = 6
        return Plan(WGMMA, 1, tile, tiles, stages, stages * (tile * 128 + 11264) + 1024)
    if bf16 and aligned and N % 32 == 0 and K % 8 == 0:
        return Plan(TENSOR_CORE, 1)
    return Plan(0, 1)


def _check(g: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor) -> tuple[int, int]:
    """Raise on what no path of the kernel takes; (K, G) otherwise."""
    N = g.shape[-1]
    if q4value.dtype != torch.uint8 or q4value.dim() != 2 or q4value.shape[1] != N:
        raise ValueError(f"int4_matmul_t: weight must be uint8 [K/2, N={N}], got "
                         f"{q4value.dtype} {tuple(q4value.shape)}")
    K = 2 * q4value.shape[0]
    if (scale4.dtype != torch.bfloat16 or scale4.dim() != 2 or scale4.shape[1] != N
            or scale4.shape[0] == 0 or K % scale4.shape[0]):
        raise ValueError(f"int4_matmul_t: scale4 must be bf16 [K/G, N={N}], got "
                         f"{scale4.dtype} {tuple(scale4.shape)}")
    G = K // scale4.shape[0]
    if G % 2:
        raise ValueError(f"int4_matmul_t: group size {G} must be even")
    if g.dtype not in _DTYPES:
        raise ValueError(f"int4_matmul_t: g dtype {g.dtype} not supported")
    for what, t in (("g", g), ("q4value", q4value), ("scale4", scale4)):
        if t.device != g.device:
            raise ValueError(f"int4_matmul_t: {what} is on {t.device}, g on {g.device}")
        if not t.is_contiguous():
            raise ValueError(f"int4_matmul_t: {what} must be contiguous")
    return K, G


def int4_matmul_t(g: torch.Tensor, q4value: torch.Tensor, scale4: torch.Tensor) -> torch.Tensor:
    """g [..., N] (f32 or bf16) @ W^T for packed q4value [K/2, N] uint8 with
    group scales scale4 [K/G, N] bf16 -> [..., K] in g's dtype. Any M, any N,
    K % G == 0 and G even. Counted as ``int4_matmul_t``."""
    if g.device.type == "cpu":
        return int4_matmul_t_plain(g, q4value, scale4)
    if g.device.type != "cuda":
        raise ValueError(f"int4_matmul_t: unsupported device {g.device}")
    *lead, N = g.shape
    K, G = _check(g, q4value, scale4)
    g2 = g.reshape(-1, N)
    M = g2.shape[0]
    dx = torch.empty((M, K), dtype=g.dtype, device=g.device)
    if M == 0:
        return dx.reshape(*lead, K)
    if -(-M // 4) > 65535:
        raise ValueError(f"int4_matmul_t: M={M} exceeds the kernel's grid")
    pl = plan(M, K, N, G, bf16=g.dtype == torch.bfloat16,
              aligned=all(t.data_ptr() % 16 == 0 for t in (g2, q4value, scale4)))
    lib = _build.library()
    err = lib.aha_int4_matmul_t(
        g2.data_ptr(), q4value.data_ptr(), scale4.data_ptr(), dx.data_ptr(), M, K, N, G,
        _DTYPES[g.dtype], pl.path, pl.tile,
        ctypes.c_void_p(torch.cuda.current_stream(g.device).cuda_stream))
    _build.check(lib, err, "int4_matmul_t")
    LAUNCHES["int4_matmul_t"] += 1
    return dx.reshape(*lead, K)
