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

``quantize_array``, ``quantize_array_int4``, ``quantize_params`` and
``merge_decoder_projections`` make those trees from dense ones, bit-equal to
the TPU package's, on the tensors' own device (a 7B tree is quantised on the
card).

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
``int4_qlinear``, whose backward is the ``int4_matmul_t`` kernel, and int8
through ``int8_qlinear``, whose forward is the ``int8_matmul`` kernel and
whose backward a product on the dequantised weight: that is what makes a
frozen int4 or int8 trunk trainable. Without a gradient to carry the plain
wrapper is called, so the serving path pays for no autograd node. The
int8-activation recipe is not differentiable (nor is it in the TPU package)
and raises.
"""

from __future__ import annotations

import torch

from .kernels.int4_matmul import int4_matmul, int4_qlinear, unpack_int4
from .kernels.int8_matmul import int8_matmul, int8_qlinear, quant_matmul

BACKENDS = ("fused", "fused_a8", "pallas")


def quantize_array(w: torch.Tensor, contract_axis: int) -> dict:
    """Symmetric int8, one scale per slice along ``contract_axis`` (the axis
    the matmul reduces): [in, out] -> scale [1, out], [L, in, out] -> [L, 1, out].
    The scale is the f32 quotient absmax / 127, at least 1e-12; each value is
    the f32 quotient ``w / scale`` rounded half to even and clipped to +-127."""
    wf = w.float()
    absmax = wf.abs().amax(dim=contract_axis, keepdim=True)
    scale = torch.clamp(absmax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return {"qvalue": q, "scale": scale}


def quantize_array_int4(w: torch.Tensor, contract_axis: int, group: int = 128) -> dict:
    """Symmetric int4 with one scale per (group of ``group`` contraction rows,
    output column), values offset by 8 and packed two a byte along K (the even
    row in the low nibble); bf16 group scales [..., K/G, N]. The kernel must
    contract on axis -2."""
    if contract_axis % w.dim() != w.dim() - 2:
        raise ValueError("int4 kernels must contract on axis -2 (the [.., K, N] layout)")
    wf = w.float()
    *lead, K, N = wf.shape
    if K % group or K % 2:
        raise ValueError(f"int4: K={K} is not a multiple of the group {group} and of 2")
    grouped = wf.reshape(*lead, K // group, group, N)
    absmax = grouped.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax / 7.0, min=1e-12)
    q = (torch.clamp(torch.round(grouped / scale), -8, 7) + 8).to(torch.uint8)
    q = q.reshape(*lead, K, N)
    return {"q4value": q[..., 0::2, :] | (q[..., 1::2, :] << 4),
            "scale4": scale.squeeze(-2).to(torch.bfloat16)}


# subtrees that stay dense: tiny, precision-sensitive, or gathered
_SKIP_SUBSTRINGS = ("norm", "ln1", "ln2", "post_ln", "bias", "scale", "pos_embed",
                    "heads", "patch_embed")


def quantize_params(params: dict, *, quantize_embed: bool = True, bits: int = 8,
                    group: int = 128, quantize_vision: bool = False,
                    keep_dense: tuple[str, ...] = ()) -> dict:
    """Every large matmul kernel of an Aha tree quantised (``aha_tpu/ops/quant.py::
    quantize_params``): ``bits`` 8 per channel, 4 packed in groups of ``group``
    (all of K where it does not divide K; int8 where K is odd); embedding tables
    int8 with per-row scales under both. The vision tower stays dense unless
    ``quantize_vision``; a leaf whose path holds one of ``keep_dense`` stays
    dense (QLoRA: ``("projector", "lm_head")``). Returns a new tree."""
    if bits not in (4, 8):
        raise ValueError(f"quantize_params: bits must be 4 or 8, got {bits}")

    def visit(node, keys):
        if isinstance(node, dict):
            return {k: visit(v, keys + (k,)) for k, v in node.items()}
        joined = "/".join(keys)
        if not quantize_vision and keys[0] == "vision":
            return node
        if any(s in joined for s in _SKIP_SUBSTRINGS + tuple(keep_dense)):
            return node
        if keys[-1] == "weight":          # an embedding table [V, H]
            return quantize_array(node, contract_axis=1) if quantize_embed else node
        if keys[-1] != "kernel" or node.dim() < 2:
            return node
        K = node.shape[-2]
        if bits == 4 and K % 2 == 0:
            return quantize_array_int4(node, node.dim() - 2, group if K % group == 0 else K)
        return quantize_array(node, contract_axis=node.dim() - 2)

    return visit(params, ())


def _concat_kernels(kernels: list) -> dict | torch.Tensor:
    """Quantized (or dense) kernels side by side along the output axis."""
    if isinstance(kernels[0], dict):
        return {k: torch.cat([kk[k] for kk in kernels], dim=-1) for k in kernels[0]}
    return torch.cat(kernels, dim=-1)


def merge_decoder_projections(llm_params: dict) -> dict:
    """q/k/v -> ``qkv_proj`` and gate/up -> ``gate_up_proj``, dense or
    quantized, concatenated along the output axis (biases too): one product
    where there were three and two, the layout the serving engine runs. Returns
    a new llm tree; the input is left as it was."""
    lyr = dict(llm_params["layers"])
    qkv = {"kernel": _concat_kernels([lyr.pop(n)["kernel"]
                                      for n in ("q_proj", "k_proj", "v_proj")])}
    biases = [llm_params["layers"][n].get("bias") for n in ("q_proj", "k_proj", "v_proj")]
    if all(b is not None for b in biases):
        qkv["bias"] = torch.cat(biases, dim=-1)
    lyr["qkv_proj"] = qkv
    lyr["gate_up_proj"] = {"kernel": _concat_kernels([lyr.pop(n)["kernel"]
                                                      for n in ("gate_proj", "up_proj")])}
    return {**llm_params, "layers": lyr}


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
    if under_grad and backend != "fused":
        raise ValueError(f"the {backend!r} backend has no gradient (the 'fused_a8' one "
                         "quantises the activations); train with backend='fused'")
    if "q4value" in qkernel:
        if backend == "pallas":
            raise ValueError("the 'pallas' backend (quant_matmul) takes int8 weights only")
        if under_grad:
            return int4_qlinear(x, qkernel["q4value"], qkernel["scale4"])
        return int4_matmul(x, qkernel["q4value"], qkernel["scale4"],
                           a8=backend == "fused_a8")
    if backend == "pallas":
        return quant_matmul(x, qkernel["qvalue"], qkernel["scale"])
    if under_grad:
        return int8_qlinear(x, qkernel["qvalue"], qkernel["scale"])
    return int8_matmul(x, qkernel["qvalue"], qkernel["scale"], a8=backend == "fused_a8")


def linear(x: torch.Tensor, p: dict, backend: str = "fused") -> torch.Tensor:
    """x @ p["kernel"] (dense [K, N] or a quantized dict) + p["bias"] if
    present: the matmul site shared by the tower, the projector, the decoder
    and the lm_head. A dense kernel of another dtype than x (a peft
    artifact's f32 projector or lm_head over a bf16 tree) promotes the product
    as JAX's einsum does: both sides in the wider dtype, so is the result; a
    bias of another dtype promotes the sum alike."""
    k = p["kernel"]
    if isinstance(k, dict):
        y = qlinear(x, k, backend)
    else:
        dt = torch.promote_types(x.dtype, k.dtype)
        y = torch.matmul(x.to(dt), k.to(dt))
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
