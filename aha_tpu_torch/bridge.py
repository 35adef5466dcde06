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

A LoRA tree (``train/lora.py::init_lora``: ``{proj: {"a", "b"}}``, layer-stacked)
crosses through ``params_from_jax`` as it is. ``numpy_from_params`` carries a
port tree (trained adapters, a trained model) the other way, to numpy leaves
that JAX takes. ``load_trained_leaves`` carries the
trained leaves of a JAX train state's tree into a port state, so that both
sides start a step from the same numbers.
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


def numpy_from_params(tree: dict) -> dict:
    """The port's nested dict of tensors (any device, with or without a
    gradient) -> numpy leaves in JAX's layout: bf16 as ``ml_dtypes.bfloat16``
    (imported only when a bf16 leaf is met), the patch kernel back to HWIO."""

    def visit(node, path):
        if isinstance(node, dict):
            return {k: visit(v, path + (k,)) for k, v in node.items()}
        t = node.detach().cpu()
        if path == PATCH_KERNEL:
            t = t.permute(2, 3, 1, 0)                    # OIHW -> HWIO
        t = t.contiguous()
        if t.dtype == torch.bfloat16:
            import ml_dtypes

            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()

    return visit(tree, ())


def load_trained_leaves(tree: dict, jax_tree: dict, labels: dict) -> None:
    """Overwrite IN PLACE every 'train'-labelled leaf of the port's
    ``tree`` ({"model": params, "lora": adapters}) with the leaf at the same
    path of ``jax_tree`` (a JAX ``TrainState.tree`` with numpy leaves);
    ``labels`` is ``train/lora.py::trainable_labels``' partition. Frozen
    leaves are left alone."""

    def visit(node, src, lab):
        for k, v in node.items():
            if isinstance(v, dict):
                visit(v, src[k], lab[k])
            elif lab[k] == "train":
                with torch.no_grad():
                    v.copy_(tensor_from_numpy(src[k]).to(device=v.device, dtype=v.dtype))

    visit(tree, jax_tree, labels)
