"""Carry an ``aha_tpu`` param tree across to the port's nested dict of tensors.

The JAX tree (``models/aha.py::init_aha_params``, optionally through
``ops/quant.py::quantize_params`` and ``merge_decoder_projections``) comes in
with numpy leaves (``jax.tree.map(np.asarray, params)`` on the JAX side, or
any leaf ``np.asarray`` accepts). Every leaf keeps its layout and dtype:
layer-stacked [L, ...] leaves, int8 ``{qvalue, scale}``, merged or split
projections, packed int4 ``{q4value, scale4}`` (uint8 / bf16). Two leaves need care:

  * bf16: numpy holds it as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
    rejects; the bits cross as uint16 and are viewed as ``torch.bfloat16``;
  * the SigLIP patch embedding is a JAX conv kernel in HWIO
    [P, P, 3, H]; torch's ``conv2d`` wants OIHW [H, 3, P, P], so it is
    permuted here (the only leaf whose layout changes).
"""

from __future__ import annotations

import numpy as np
import torch

PATCH_KERNEL = ("vision", "patch_embed", "kernel")


def tensor_from_numpy(arr) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_jax(tree: dict, device="cuda") -> dict:
    """JAX param tree (numpy leaves) -> nested dict of torch tensors on
    ``device`` (the card unless the caller asks for ``"cpu"``)."""

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        t = tensor_from_numpy(node)
        if path == PATCH_KERNEL:
            t = t.permute(3, 2, 0, 1).contiguous()   # HWIO -> OIHW
        return t.to(device)

    return visit(tree, ())
