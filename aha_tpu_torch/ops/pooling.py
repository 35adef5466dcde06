"""Spatial pooling of the vision tower's patch grid.

Counterpart of ``aha_tpu/ops/pooling.py``: adaptive average pooling as two
small matmuls with the torch-convention bin matrices (bin i covers
[floor(i*in/out), ceil((i+1)*in/out))), plus the stride-s max / average
modes.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _adaptive_avg_matrix(in_size: int, out_size: int) -> np.ndarray:
    M = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        start = (i * in_size) // out_size
        end = math.ceil((i + 1) * in_size / out_size)
        M[i, start:end] = 1.0 / (end - start)
    return M


def pool_patch_tokens(tokens: torch.Tensor, grid: int, out_hw: tuple[int, int],
                      mode: str = "average") -> torch.Tensor:
    """[N, grid*grid, C] -> [N, ph*pw, C] in the input dtype."""
    N, T, C = tokens.shape
    if T != grid * grid:
        raise ValueError(f"{T} tokens do not form a {grid}x{grid} grid")
    x = tokens.reshape(N, grid, grid, C)
    if mode == "average":
        mh = torch.as_tensor(_adaptive_avg_matrix(grid, out_hw[0]), device=x.device)
        mw = torch.as_tensor(_adaptive_avg_matrix(grid, out_hw[1]), device=x.device)
        y = torch.einsum("ph,nhwc->npwc", mh, x.float())
        y = torch.einsum("qw,npwc->npqc", mw, y)
    elif mode in ("max", "stride_average"):
        s = grid // out_hw[0]
        trim = out_hw[0] * s
        xw = x[:, :trim, :trim].reshape(N, out_hw[0], s, out_hw[1], s, C)
        y = xw.amax(dim=(2, 4)) if mode == "max" else xw.float().mean(dim=(2, 4))
    else:
        raise ValueError(f"unknown pooling mode {mode}")
    return y.reshape(N, out_hw[0] * out_hw[1], C).to(tokens.dtype)
