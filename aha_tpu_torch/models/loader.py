"""The weights: JAX's synthetic trees drawn exactly, and checkpoints.

Counterpart of ``aha_tpu/models/loader.py``, both towers (SigLIP, with its
MAP probe where the config or the checkpoint has one, and CLIP):

  * ``materialize_random_params(cfg, mode, keep_dense, device)``: the tree
    that ``aha_tpu``'s ``materialize_random_params`` builds, leaf by leaf on
    ``device`` with ``models/jax_random.py``: integer leaves bit-equal to
    JAX's, float leaves within one step of their dtype. ``leaf_specs`` is the
    JAX tree's leaf list (path, shape, dtype in ``tree_map_with_path`` order),
    made without JAX: the dense tree of ``init_aha_params`` on the meta device,
    through ``ops/quant.py::quantize_params``. Leaf i (from 1) is drawn from
    ``PRNGKey(i)``, slab by slab (``jax_random.SLAB`` values), in JAX's layout;
    then the patch kernel goes HWIO -> OIHW and, quantised, q/k/v and gate/up
    are merged (the layout JAX's engine serves);
  * ``convert_qwen2`` / ``convert_siglip`` / ``convert_clip`` /
    ``convert_projector_heads``: a Hugging Face state dict (torch [out, in]
    tensors) -> the port's tree ([in, out] kernels stacked on a leading layer
    axis, the patch kernel kept OIHW); ``export_hf_state_dict`` is their
    inverse;
  * ``load_params(path, cfg, dtype, device)``: a checkpoint directory of
    ``.safetensors`` shards (read by ``read_safetensors``: no ``safetensors``
    package needed) or torch ``.bin`` / ``.pt`` shards; ``save_safetensors``
    writes shards;
  * ``load_adapter(path, cfg, dtype, device)``: a peft adapter-only
    checkpoint directory (the published Aha artifact): its LoRA pairs
    (``convert_peft_lora``), its ``modules_to_save`` as partial param
    overrides (``convert_peft_modules_to_save``, merged by
    ``apply_overrides``) and ``lora_alpha / r`` from ``adapter_config.json``;
    ``save_adapter`` writes such a directory;
  * ``save_converted`` / ``load_converted``: ``torch.save`` / ``torch.load``
    of a converted tree.

Every entry point that makes tensors runs on the card unless ``device`` says
otherwise.
"""

from __future__ import annotations

import json
import math
import mmap
import os

import torch

from ..bridge import PATCH_KERNEL
from ..config import AhaConfig, QwenConfig, SiglipConfig
from ..ops import quant
from . import jax_random

# -- JAX's synthetic trees ------------------------------------------------------


def _check_device(device, what: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{what}: device cuda requested but no GPU is available "
                           "(pass device='cpu' to run on the host)")
    return device


def _jax_dense_tree(cfg: AhaConfig) -> dict:
    """``init_aha_params``' tree on the meta device: JAX's shapes and layout
    (the patch kernel HWIO), every leaf in ``cfg.dtype``."""
    from .aha import torch_dtype

    dt = torch_dtype(cfg.dtype)

    def t(*shape):
        return torch.empty(shape, dtype=dt, device="meta")

    v, q = cfg.vision, cfg.llm
    L, H, I, QD, KD = q.num_layers, q.hidden_size, q.intermediate_size, q.q_dim, q.kv_dim
    Lv, Hv, Iv, P = v.num_layers, v.hidden_size, v.intermediate_size, v.patch_size

    def lin(*shape, bias=True):
        return {"kernel": t(*shape), **({"bias": t(*shape[:-2], shape[-1])} if bias else {})}

    layers = {
        "ln1": {"scale": t(Lv, Hv), "bias": t(Lv, Hv)},
        **{n: lin(Lv, Hv, Hv) for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
        "ln2": {"scale": t(Lv, Hv), "bias": t(Lv, Hv)},
        "fc1": lin(Lv, Hv, Iv),
        "fc2": lin(Lv, Iv, Hv),
    }
    if v.arch == "clip":
        vision = {"cls_embed": t(Hv), "patch_embed": {"kernel": t(P, P, 3, Hv)},
                  "pos_embed": t(v.num_patches + 1, Hv),
                  "pre_ln": {"scale": t(Hv), "bias": t(Hv)}, "layers": layers}
    else:
        vision = {"patch_embed": {"kernel": t(P, P, 3, Hv), "bias": t(Hv)},
                  "pos_embed": t(v.num_patches, Hv), "layers": layers,
                  "post_ln": {"scale": t(Hv), "bias": t(Hv)}}
        if v.use_head or cfg.frame_token_cls:    # the MAP probe head, as JAX makes it
            vision["head"] = {"probe": t(1, Hv),
                              **{n: lin(Hv, Hv) for n in ("q_proj", "k_proj", "v_proj",
                                                          "out_proj")},
                              "ln": {"scale": t(Hv), "bias": t(Hv)},
                              "fc1": lin(Hv, Iv), "fc2": lin(Iv, Hv)}
    llm = {
        "embed": {"weight": t(q.vocab_size, H)},
        "layers": {
            "input_norm": {"scale": t(L, H)},
            "q_proj": lin(L, H, QD), "k_proj": lin(L, H, KD), "v_proj": lin(L, H, KD),
            "o_proj": lin(L, QD, H, bias=False),
            "post_norm": {"scale": t(L, H)},
            **{n: lin(L, H, I, bias=False) for n in ("gate_proj", "up_proj")},
            "down_proj": lin(L, I, H, bias=False),
        },
        "final_norm": {"scale": t(H)},
    }
    if not q.tie_word_embeddings:
        llm["lm_head"] = lin(H, q.vocab_size, bias=False)
    return {
        "vision": vision,
        "projector": {"fc1": lin(Hv, H), "fc2": lin(H, H)},
        "llm": llm,
        "heads": {n: lin(H, c, bias=False)
                  for n, c in (("informative", 2), ("relevance", 1), ("uncertainty", 1))},
    }


def _quantize(tree: dict, mode: str | None, keep_dense: tuple[str, ...]) -> dict:
    if mode is None:
        return tree
    if mode not in ("int8", "int4"):
        raise ValueError(f"mode must be None, 'int8' or 'int4', got {mode!r}")
    return quant.quantize_params(tree, bits=4 if mode == "int4" else 8, keep_dense=keep_dense)


def _flatten(tree: dict, prefix: tuple = ()) -> list:
    """(path, leaf) in ``tree_map_with_path`` order: keys sorted at every level."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out += _flatten(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)]
    return out


def leaf_specs(cfg: AhaConfig, mode: str | None = None, keep_dense: tuple[str, ...] = ()
               ) -> list[tuple[tuple[str, ...], tuple, torch.dtype]]:
    """JAX's leaf list of ``init_aha_params(cfg)`` after ``quantize_params`` in
    ``mode`` (unmerged): (path, shape, dtype) in the order JAX draws them."""
    tree = _quantize(_jax_dense_tree(cfg), mode, keep_dense)
    return [(path, tuple(t.shape), t.dtype) for path, t in _flatten(tree)]


def draw_leaf(path: tuple[str, ...], shape, dtype: torch.dtype, counter: int, start: int = 0,
              stop: int | None = None, device="cpu") -> torch.Tensor:
    """Flat values ``start`` .. ``stop`` of leaf number ``counter`` (from 1) of
    ``materialize_random_params``, in JAX's layout: the name predicates of
    ``aha_tpu/models/loader.py::materialize_random_params`` in their order."""
    key = jax_random.prng_key(counter)
    name = "/".join(path)
    n = math.prod(shape) if stop is None else stop
    count = n - start
    if dtype == torch.uint8:                       # packed int4 nibbles
        return jax_random.randint(key, shape, 0, 256, start, stop, device).to(torch.uint8)
    if name.endswith("/scale4"):
        return torch.full((count,), 0.02 / 7.0, dtype=dtype, device=device)
    if dtype == torch.int8:
        return jax_random.randint(key, shape, -127, 128, start, stop, device).to(torch.int8)
    if name.endswith("/scale") and "norm" not in name and "ln" not in name:
        return torch.full((count,), 0.02 / 127.0, dtype=dtype, device=device)
    if "norm" in name or "post_ln" in name or "/ln1/" in name or "/ln2/" in name:
        return torch.ones((count,), dtype=dtype, device=device)
    if name.endswith("/bias"):
        return torch.zeros((count,), dtype=dtype, device=device)
    return (0.02 * jax_random.normal(key, shape, start, stop, device)).to(dtype)


def _port_tree(leaves) -> dict:
    """(path, leaf in JAX's layout) pairs -> the port's nested tree: the patch
    kernel goes HWIO -> OIHW, the only leaf whose layout changes."""
    tree: dict = {}
    for path, leaf in leaves:
        if path == PATCH_KERNEL:
            leaf = leaf.permute(3, 2, 0, 1).contiguous()
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return tree


def materialize_random_params(cfg: AhaConfig, mode: str | None = None,
                              keep_dense: tuple[str, ...] = (), device="cuda",
                              slab: int = jax_random.SLAB) -> dict:
    """The synthetic tree of ``aha_tpu``'s ``materialize_random_params(cfg,
    mode, keep_dense)``, built leaf by leaf on ``device`` in its final dtype
    and the port's layout; ``mode`` None (``cfg.dtype``), ``"int8"`` or
    ``"int4"`` (then q/k/v and gate/up merged). Each leaf is drawn in slabs of
    ``slab`` values, so no counter tensor is larger than a slab."""
    device = _check_device(device, "materialize_random_params")

    def leaves():
        for counter, (path, shape, dtype) in enumerate(leaf_specs(cfg, mode, keep_dense), 1):
            leaf = torch.empty(shape, dtype=dtype, device=device)
            flat = leaf.view(-1)
            for start in range(0, flat.numel(), slab):
                stop = min(start + slab, flat.numel())
                flat[start:stop] = draw_leaf(path, shape, dtype, counter, start, stop, device)
            yield path, leaf

    tree = _port_tree(leaves())
    if mode is not None:
        tree["llm"] = quant.merge_decoder_projections(tree["llm"])
    return tree


def init_aha_params(cfg: AhaConfig, seed: int = 0, dtype: str | None = None,
                    device="cuda", slab: int = jax_random.SLAB) -> dict:
    """The tree of ``aha_tpu``'s ``init_aha_params(cfg, PRNGKey(seed), dtype)``
    (what JAX's command line serves with neither a checkpoint nor synthetic
    weights, and the tiny golden fixture's weights): its keys split as JAX
    splits them, kernels and embeddings ``0.02 * normal`` in ``dtype``
    (``cfg.dtype`` by default), norms one, biases zero; the port's layout.
    Each leaf is drawn in slabs of ``slab`` values, as in
    ``materialize_random_params``: a whole 7B leaf's counters would take tens
    of GB."""
    from .aha import torch_dtype

    device = _check_device(device, "init_aha_params")
    tree = _jax_dense_tree(cfg)
    dt = torch_dtype(dtype or cfg.dtype)
    kv, kp, kl, _ = jax_random.split(jax_random.prng_key(seed), 4)
    # the projector's and the heads' five keys all come from kp (JAX leaves its
    # fourth key unused)
    draws = dict(zip((("projector", "fc1"), ("projector", "fc2"), ("heads", "informative"),
                      ("heads", "relevance"), ("heads", "uncertainty")),
                     jax_random.split(kp, 5)))
    # the order the SigLIP tower's init draws its keys in (``next(ks)`` down its dict);
    # the CLIP tower is clip.init_params' own
    clip_tower = cfg.vision.arch == "clip"
    if clip_tower:
        del tree["vision"]
    else:
        ks = iter(jax_random.split(kv, 16))
        for path in (("patch_embed",), ("pos_embed",), *(("layers", n) for n in (
                "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"))):
            draws[("vision", *path)] = next(ks)
        if "head" in tree["vision"]:
            for n in ("probe", "q_proj", "k_proj", "v_proj", "out_proj", "fc1", "fc2"):
                draws[("vision", "head", n)] = next(ks)
    ks = iter(jax_random.split(kl, 16))
    for path in (*(("layers", n) for n in ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj",
                                           "up_proj", "down_proj")), ("embed",), ("lm_head",)):
        draws[("llm", *path)] = next(ks)
    def leaves():
        for path, meta in _flatten(tree):
            key = draws.get(path[:-1] if path[-1] in ("kernel", "weight") else path)
            if key is None:       # norms and biases
                make = torch.zeros if path[-1] == "bias" else torch.ones
                yield path, make(meta.shape, dtype=dt, device=device)
            else:
                leaf = torch.empty(meta.shape, dtype=dt, device=device)
                flat = leaf.view(-1)
                for start in range(0, flat.numel(), slab):
                    stop = min(start + slab, flat.numel())
                    flat[start:stop] = (0.02 * jax_random.normal(key, meta.shape, start, stop,
                                                                 device)).to(dt)
                yield path, leaf

    out = _port_tree(leaves())
    if clip_tower:
        from . import clip

        out["vision"] = clip.init_params(cfg.vision, kv, dt, device, slab)
    return out


# -- Hugging Face state dicts <-> the port's tree -------------------------------------


def _stack(sd: dict, template: str, n: int, dtype, device, transpose: bool = False):
    """The n per-layer tensors of ``template`` stacked on a new leading axis
    ([out, in] -> [in, out] with ``transpose``), each moved to ``device`` first
    (so a transpose runs there)."""
    arrs = [sd[template.format(i=i)].to(device=device, dtype=dtype) for i in range(n)]
    return torch.stack([a.T if transpose else a for a in arrs])


def _one(sd: dict, key: str, dtype, device, transpose: bool = False):
    a = sd[key].to(device=device, dtype=dtype)
    return a.T.contiguous() if transpose else a.contiguous()


def _linear_layers(sd, lyr: str, names: dict, n: int, dtype, device, bias: bool) -> dict:
    return {ours: {"kernel": _stack(sd, lyr + theirs + ".weight", n, dtype, device, True),
                   **({"bias": _stack(sd, lyr + theirs + ".bias", n, dtype, device)}
                      if bias else {})}
            for ours, theirs in names.items()}


def convert_qwen2(sd: dict, cfg: QwenConfig, prefix: str = "model.",
                  dtype=torch.float32, device="cuda") -> dict:
    """A Qwen2 state dict -> the decoder tree. ``prefix`` is where the decoder
    sits ('model.' in a bare Qwen2ForCausalLM, 'language_model.model.' in
    composite checkpoints)."""
    device = _check_device(device, "convert_qwen2")
    L, p = cfg.num_layers, prefix
    lyr = p + "layers.{i}."
    layers = {
        "input_norm": {"scale": _stack(sd, lyr + "input_layernorm.weight", L, dtype, device)},
        **_linear_layers(sd, lyr, {n: f"self_attn.{n}" for n in ("q_proj", "k_proj", "v_proj")},
                         L, dtype, device, bias=True),
        **_linear_layers(sd, lyr, {"o_proj": "self_attn.o_proj"}, L, dtype, device, bias=False),
        "post_norm": {"scale": _stack(sd, lyr + "post_attention_layernorm.weight", L, dtype,
                                      device)},
        **_linear_layers(sd, lyr, {n: f"mlp.{n}" for n in ("gate_proj", "up_proj", "down_proj")},
                         L, dtype, device, bias=False),
    }
    out = {
        "embed": {"weight": _one(sd, p + "embed_tokens.weight", dtype, device)},
        "layers": layers,
        "final_norm": {"scale": _one(sd, p + "norm.weight", dtype, device)},
    }
    if not cfg.tie_word_embeddings:
        out["lm_head"] = {"kernel": _one(sd, "lm_head.weight", dtype, device, transpose=True)}
    return out


_SIGLIP_LAYER = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
                 "v_proj": "self_attn.v_proj", "out_proj": "self_attn.out_proj",
                 "fc1": "mlp.fc1", "fc2": "mlp.fc2"}


def convert_siglip(sd: dict, cfg: SiglipConfig, prefix: str = "vision_model.",
                   dtype=torch.float32, device="cuda") -> dict:
    """A SigLIP vision state dict -> the tower tree; the patch kernel stays in
    torch's OIHW [H, 3, P, P]. The MAP probe head comes along where the
    checkpoint has it (``q/k/v`` split out of ``in_proj``)."""
    device = _check_device(device, "convert_siglip")
    L, p = cfg.num_layers, prefix
    lyr = p + "encoder.layers.{i}."

    def norm(name, n=None):
        if n is None:
            return {"scale": _one(sd, name + ".weight", dtype, device),
                    "bias": _one(sd, name + ".bias", dtype, device)}
        return {"scale": _stack(sd, name + ".weight", n, dtype, device),
                "bias": _stack(sd, name + ".bias", n, dtype, device)}

    layers = {"ln1": norm(lyr + "layer_norm1", L), "ln2": norm(lyr + "layer_norm2", L),
              **_linear_layers(sd, lyr, _SIGLIP_LAYER, L, dtype, device, bias=True)}
    out = {
        "patch_embed": {"kernel": _one(sd, p + "embeddings.patch_embedding.weight", dtype, device),
                        "bias": _one(sd, p + "embeddings.patch_embedding.bias", dtype, device)},
        "pos_embed": _one(sd, p + "embeddings.position_embedding.weight", dtype, device),
        "layers": layers,
        "post_ln": norm(p + "post_layernorm"),
    }
    if p + "head.probe" in sd:
        h = p + "head."
        w = sd[h + "attention.in_proj_weight"].to(device=device, dtype=dtype)
        b = sd[h + "attention.in_proj_bias"].to(device=device, dtype=dtype)
        H = w.shape[1]
        out["head"] = {
            "probe": _one(sd, h + "probe", dtype, device).reshape(1, H),
            **{n: {"kernel": w[i * H:(i + 1) * H].T.contiguous(),
                   "bias": b[i * H:(i + 1) * H].contiguous()}
               for i, n in enumerate(("q_proj", "k_proj", "v_proj"))},
            "out_proj": {"kernel": _one(sd, h + "attention.out_proj.weight", dtype, device, True),
                         "bias": _one(sd, h + "attention.out_proj.bias", dtype, device)},
            "ln": norm(h + "layernorm"),
            **{n: {"kernel": _one(sd, h + f"mlp.{n}.weight", dtype, device, True),
                   "bias": _one(sd, h + f"mlp.{n}.bias", dtype, device)} for n in ("fc1", "fc2")},
        }
    return out


def convert_clip(sd: dict, cfg: SiglipConfig, prefix: str = "vision_model.",
                 dtype=torch.float32, device="cuda") -> dict:
    """A CLIPVisionModel state dict -> the CLIP tower's tree; the patch kernel
    stays in torch's OIHW. CLIP's patch conv has no bias, the CLS token and
    the pre-LN are its own, and its post-LN is dropped (the reference reads
    the un-normalised last hidden state)."""
    device = _check_device(device, "convert_clip")
    L, p = cfg.num_layers, prefix
    lyr = p + "encoder.layers.{i}."

    def norm(name, n=None):
        if n is None:
            return {"scale": _one(sd, name + ".weight", dtype, device),
                    "bias": _one(sd, name + ".bias", dtype, device)}
        return {"scale": _stack(sd, name + ".weight", n, dtype, device),
                "bias": _stack(sd, name + ".bias", n, dtype, device)}

    return {
        "cls_embed": _one(sd, p + "embeddings.class_embedding", dtype, device),
        "patch_embed": {"kernel": _one(sd, p + "embeddings.patch_embedding.weight", dtype,
                                       device)},
        "pos_embed": _one(sd, p + "embeddings.position_embedding.weight", dtype, device),
        "pre_ln": norm(p + "pre_layrnorm"),
        "layers": {"ln1": norm(lyr + "layer_norm1", L), "ln2": norm(lyr + "layer_norm2", L),
                   **_linear_layers(sd, lyr, _SIGLIP_LAYER, L, dtype, device, bias=True)},
    }


_HEADS = ("informative", "relevance", "uncertainty")


def convert_projector_heads(sd: dict, dtype=torch.float32, device="cuda") -> tuple[dict, dict]:
    """The mm_projector (Linear, GELU, Linear) and the three score heads."""
    device = _check_device(device, "convert_projector_heads")
    projector = {f"fc{j}": {"kernel": _one(sd, f"model.mm_projector.{i}.weight", dtype, device,
                                           True),
                            "bias": _one(sd, f"model.mm_projector.{i}.bias", dtype, device)}
                 for j, i in ((1, 0), (2, 2))}
    heads = {n: {"kernel": _one(sd, f"{n}_head.weight", dtype, device, True)} for n in _HEADS}
    return projector, heads


def export_hf_state_dict(params: dict, cfg: AhaConfig,
                         vis_prefix: str = "model.vision_tower.vision_tower.vision_model.",
                         ) -> dict:
    """A dense port tree (q/k/v and gate/up unmerged) -> a Hugging Face style
    state dict, the inverse of the converters: kernels back to torch's
    [out, in], stacked layers to per-layer keys. ``vis_prefix`` defaults to
    llava-onevision's nesting (the tower wrapped twice). Values are views of
    the tree's tensors where they can be (a writer copies them one by one)."""
    sd: dict = {}
    llm = params["llm"]
    sd["model.embed_tokens.weight"] = llm["embed"]["weight"]
    sd["model.norm.weight"] = llm["final_norm"]["scale"]
    if "lm_head" in llm:
        sd["lm_head.weight"] = llm["lm_head"]["kernel"].T
    lyr = llm["layers"]
    for i in range(cfg.llm.num_layers):
        p = f"model.layers.{i}."
        sd[p + "input_layernorm.weight"] = lyr["input_norm"]["scale"][i]
        sd[p + "post_attention_layernorm.weight"] = lyr["post_norm"]["scale"][i]
        for proj in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[p + f"self_attn.{proj}.weight"] = lyr[proj]["kernel"][i].T
            if "bias" in lyr[proj]:
                sd[p + f"self_attn.{proj}.bias"] = lyr[proj]["bias"][i]
        for proj in ("gate_proj", "up_proj", "down_proj"):
            sd[p + f"mlp.{proj}.weight"] = lyr[proj]["kernel"][i].T
    vis, vp = params["vision"], vis_prefix
    clip_tower = cfg.vision.arch == "clip"
    sd[vp + "embeddings.patch_embedding.weight"] = vis["patch_embed"]["kernel"]
    if not clip_tower:
        sd[vp + "embeddings.patch_embedding.bias"] = vis["patch_embed"]["bias"]
    sd[vp + "embeddings.position_embedding.weight"] = vis["pos_embed"]
    if clip_tower:
        sd[vp + "embeddings.class_embedding"] = vis["cls_embed"]
        sd[vp + "pre_layrnorm.weight"] = vis["pre_ln"]["scale"]
        sd[vp + "pre_layrnorm.bias"] = vis["pre_ln"]["bias"]
    else:
        sd[vp + "post_layernorm.weight"] = vis["post_ln"]["scale"]
        sd[vp + "post_layernorm.bias"] = vis["post_ln"]["bias"]
    vmap = {"ln1": "layer_norm1", "ln2": "layer_norm2", **_SIGLIP_LAYER}
    vl = vis["layers"]
    for i in range(cfg.vision.num_layers):
        for ours, theirs in vmap.items():
            p = vp + f"encoder.layers.{i}.{theirs}."
            sd[p + "weight"] = (vl[ours]["kernel"][i].T if "kernel" in vl[ours]
                                else vl[ours]["scale"][i])
            sd[p + "bias"] = vl[ours]["bias"][i]
    if "head" in vis:
        h, hp = vis["head"], vp + "head."
        sd[hp + "probe"] = h["probe"].reshape(1, 1, -1)
        sd[hp + "attention.in_proj_weight"] = torch.cat(
            [h[n]["kernel"].T for n in ("q_proj", "k_proj", "v_proj")])
        sd[hp + "attention.in_proj_bias"] = torch.cat(
            [h[n]["bias"] for n in ("q_proj", "k_proj", "v_proj")])
        sd[hp + "attention.out_proj.weight"] = h["out_proj"]["kernel"].T
        sd[hp + "attention.out_proj.bias"] = h["out_proj"]["bias"]
        sd[hp + "layernorm.weight"] = h["ln"]["scale"]
        sd[hp + "layernorm.bias"] = h["ln"]["bias"]
        for n in ("fc1", "fc2"):
            sd[hp + f"mlp.{n}.weight"] = h[n]["kernel"].T
            sd[hp + f"mlp.{n}.bias"] = h[n]["bias"]
    proj = params["projector"]
    for j, i in ((1, 0), (2, 2)):
        sd[f"model.mm_projector.{i}.weight"] = proj[f"fc{j}"]["kernel"].T
        sd[f"model.mm_projector.{i}.bias"] = proj[f"fc{j}"]["bias"]
    for n in _HEADS:
        sd[f"{n}_head.weight"] = params["heads"][n]["kernel"].T
    return sd


# -- safetensors files, without the safetensors package ------------------------------

_ST_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
              "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
              "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_ST_NAMES = {v: k for k, v in _ST_DTYPES.items()}


def read_safetensors(path: str) -> dict:
    """All tensors of one ``.safetensors`` file: an 8-byte little-endian header
    length, a JSON header (dtype, shape, byte offsets per tensor), then raw
    little-endian data. The file is mapped, not read: each tensor is a CPU view
    of the mapping, paged in when it is used."""
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    base = 8 + n
    out = {}
    for key, info in header.items():
        if key == "__metadata__":
            continue
        dtype = _ST_DTYPES[info["dtype"]]
        begin, end = info["data_offsets"]
        shape = info["shape"]
        count = math.prod(shape)
        if end - begin != count * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{path}: {key} holds {end - begin} bytes for {shape} {dtype}")
        t = (torch.frombuffer(buf, dtype=dtype, count=count, offset=base + begin) if count
             else torch.empty(0, dtype=dtype))
        out[key] = t.reshape(shape)
    return out


def save_safetensors(tensors: dict, path: str, metadata: dict | None = None) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) as one
    ``.safetensors`` file that the ``safetensors`` package reads; returns the
    bytes written."""
    header: dict = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for key, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        header[key] = {"dtype": _ST_NAMES[t.dtype], "shape": list(t.shape),
                       "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)                 # data starts 8-byte aligned
    with open(path, "wb") as f:
        f.write(len(blob).to_bytes(8, "little"))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(memoryview(t.detach().contiguous().cpu().reshape(-1)
                                   .view(torch.uint8).numpy()))
    return 8 + len(blob) + offset


def save_sharded(tensors: dict, directory: str, max_shard_bytes: int = 5 * 10**9) -> list[str]:
    """``tensors`` as ``model-0000i-of-0000n.safetensors`` shards of at most
    ``max_shard_bytes`` each (a tensor larger than that gets a shard of its
    own) and ``model.safetensors.index.json``; returns the shard paths."""
    shards, size = [[]], 0
    for key, t in tensors.items():
        nbytes = t.numel() * t.element_size()
        if shards[-1] and size + nbytes > max_shard_bytes:
            shards.append([])
            size = 0
        shards[-1].append(key)
        size += nbytes
    os.makedirs(directory, exist_ok=True)
    paths, weight_map = [], {}
    for i, keys in enumerate(shards, 1):
        name = f"model-{i:05d}-of-{len(shards):05d}.safetensors"
        save_safetensors({k: tensors[k] for k in keys}, os.path.join(directory, name),
                         {"format": "pt"})
        paths.append(os.path.join(directory, name))
        weight_map.update({k: name for k in keys})
    with open(os.path.join(directory, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {}, "weight_map": weight_map}, f)
    return paths


def read_state_dict(path: str) -> dict:
    """Every tensor of a checkpoint directory: its ``.safetensors`` shards where
    it has them (mapped, see ``read_safetensors``), else its torch ``.bin`` /
    ``.pt`` shards (``torch.load(weights_only=True)`` on the CPU)."""
    files = sorted(os.listdir(path))
    st = [f for f in files if f.endswith(".safetensors")]
    pt = [f for f in files if f.endswith((".bin", ".pt"))]
    sd: dict = {}
    if st:
        for f in st:
            sd.update(read_safetensors(os.path.join(path, f)))
    elif pt:
        for f in pt:
            sd.update(torch.load(os.path.join(path, f), map_location="cpu", weights_only=True))
    else:
        raise FileNotFoundError(f"no .safetensors / .bin shards in {path}")
    return sd


def load_params(path: str, cfg: AhaConfig, dtype=torch.float32, device="cuda") -> dict:
    """A reference-style checkpoint directory -> the port's dense tree in
    ``dtype`` on ``device``: the decoder under 'model.' or
    'language_model.model.', the tower (``cfg.vision.arch``: SigLIP or CLIP)
    under whatever prefix holds 'embeddings.patch_embedding.weight'."""
    sd = read_state_dict(path)
    llm_prefix = "model." if "model.embed_tokens.weight" in sd else "language_model.model."
    suffix = "embeddings.patch_embedding.weight"
    vis_prefix = next((k[:-len(suffix)] for k in sd if k.endswith(suffix)), "vision_model.")
    convert_vision = convert_clip if cfg.vision.arch == "clip" else convert_siglip
    params = {"llm": convert_qwen2(sd, cfg.llm, llm_prefix, dtype, device),
              "vision": convert_vision(sd, cfg.vision, vis_prefix, dtype, device)}
    params["projector"], params["heads"] = convert_projector_heads(sd, dtype, device)
    return params


# -- peft adapter-only checkpoints ------------------------------------------------------

_PEFT_PROJS = {"q_proj": "self_attn.q_proj", "k_proj": "self_attn.k_proj",
               "v_proj": "self_attn.v_proj", "o_proj": "self_attn.o_proj",
               "gate_proj": "mlp.gate_proj", "up_proj": "mlp.up_proj",
               "down_proj": "mlp.down_proj"}


def convert_peft_lora(sd: dict, cfg: QwenConfig, dtype=torch.float32, device="cuda") -> dict:
    """A peft LoRA state dict -> the port's stacked adapter tree ``{proj: {"a":
    [L, in, r], "b": [L, r, out]}}``. peft's keys are
    ``<prefix>layers.{i}.self_attn.q_proj.lora_A.weight`` ([r, in]) and
    ``...lora_B.weight`` ([out, r]); the prefix (the wrapping depth) is read off
    layer 0's first lora_A key. A projection without adapters is left out."""
    device = _check_device(device, "convert_peft_lora")
    sample = next((k for k in sd if ".lora_A." in k and "layers.0." in k), None)
    if sample is None:
        raise ValueError("convert_peft_lora: no lora_A keys in the state dict")
    prefix = sample.split("layers.0.")[0]
    tree = {}
    for name, hf_name in _PEFT_PROJS.items():
        a_tmpl = prefix + "layers.{i}." + hf_name + ".lora_A.weight"
        if a_tmpl.format(i=0) not in sd:
            continue
        b_tmpl = a_tmpl.replace(".lora_A.", ".lora_B.")
        tree[name] = {"a": _stack(sd, a_tmpl, cfg.num_layers, dtype, device, transpose=True),
                      "b": _stack(sd, b_tmpl, cfg.num_layers, dtype, device, transpose=True)}
    return tree


def convert_peft_modules_to_save(sd: dict, dtype=torch.float32, device="cuda") -> dict:
    """The dense modules a peft checkpoint saves beside its adapters (the
    mm_projector, the three score heads, the lm_head) as partial param
    overrides keyed like the port's tree, kernels [in, out]; a module the
    checkpoint lacks is left out."""
    device = _check_device(device, "convert_peft_modules_to_save")

    def find(suffix, transpose=False):
        key = next((k for k in sd if k.endswith(suffix)), None)
        return None if key is None else _one(sd, key, dtype, device, transpose)

    out: dict = {}
    if any(k.endswith("mm_projector.0.weight") for k in sd):
        fcs = {f"fc{j}": {"kernel": find(f"mm_projector.{i}.weight", True),
                          "bias": find(f"mm_projector.{i}.bias")} for j, i in ((1, 0), (2, 2))}
        out["projector"] = {n: {k: t for k, t in fc.items() if t is not None}
                            for n, fc in fcs.items()}
    heads = {n: find(f"{n}_head.weight", True) for n in _HEADS}
    if any(w is not None for w in heads.values()):
        out["heads"] = {n: {"kernel": w} for n, w in heads.items() if w is not None}
    lm = find("lm_head.weight", True)
    if lm is not None:
        out["llm"] = {"lm_head": {"kernel": lm}}
    return out


def load_adapter(path: str, cfg: AhaConfig, dtype=torch.float32,
                 device="cuda") -> tuple[dict, dict, float]:
    """A peft adapter-only checkpoint directory (``.safetensors`` or torch
    shards, read by ``read_state_dict``) -> (adapters, overrides, lora_scale)
    in ``dtype`` on ``device``. ``lora_scale`` is ``lora_alpha / r`` from
    ``adapter_config.json`` where the directory has one (``lora_alpha``
    defaulting to 2 r), else the reference's 32 / 16."""
    sd = read_state_dict(path)
    lora = convert_peft_lora(sd, cfg.llm, dtype, device)
    overrides = convert_peft_modules_to_save(sd, dtype, device)
    scale = 32.0 / 16.0
    cfg_path = os.path.join(path, "adapter_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            ac = json.load(f)
        if ac.get("r"):
            scale = float(ac.get("lora_alpha", 2 * ac["r"])) / float(ac["r"])
    return lora, overrides, scale


def save_adapter(path: str, lora: dict, lora_scale: float, params: dict | None = None) -> str:
    """``load_adapter``'s inverse: ``lora`` (``{proj: {"a": [L, in, r], "b":
    [L, r, out]}}``, any device) as a peft adapter-only directory,
    ``adapter_model.safetensors`` with peft's keys and ``adapter_config.json``
    (r, ``lora_alpha = lora_scale * r``); with ``params``, its dense projector,
    score heads and lm_head go beside the adapters as modules_to_save, f32.
    Returns the directory."""
    pre = "base_model.model."
    sd = {}
    for name, ab in lora.items():
        hf = _PEFT_PROJS[name]
        for i in range(ab["a"].shape[0]):
            sd[f"{pre}model.layers.{i}.{hf}.lora_A.weight"] = ab["a"][i].T.float().contiguous()
            sd[f"{pre}model.layers.{i}.{hf}.lora_B.weight"] = ab["b"][i].T.float().contiguous()
    modules = []
    if params is not None:
        dense = lambda p: not isinstance(p["kernel"], dict)
        proj = params.get("projector", {})
        if proj and all(dense(p) for p in proj.values()):
            for j, i in ((1, 0), (2, 2)):
                sd[f"{pre}model.mm_projector.{i}.weight"] = proj[f"fc{j}"]["kernel"].T.float()
                sd[f"{pre}model.mm_projector.{i}.bias"] = proj[f"fc{j}"]["bias"].float()
            modules.append("mm_projector")
        for n in _HEADS:
            sd[f"{pre}{n}_head.weight"] = params["heads"][n]["kernel"].T.float()
            modules.append(f"{n}_head")
        lm = params["llm"].get("lm_head")
        if lm is not None and dense(lm):
            sd[f"{pre}lm_head.weight"] = lm["kernel"].T.float()
            modules.append("lm_head")
    os.makedirs(path, exist_ok=True)
    save_safetensors({k: v.contiguous() for k, v in sd.items()},
                     os.path.join(path, "adapter_model.safetensors"), {"format": "pt"})
    r = next(iter(lora.values()))["a"].shape[-1]
    with open(os.path.join(path, "adapter_config.json"), "w") as f:
        json.dump({"peft_type": "LORA", "r": r, "lora_alpha": lora_scale * r,
                   "target_modules": sorted(lora), "modules_to_save": modules,
                   "task_type": "CAUSAL_LM"}, f, indent=1)
    return path


def apply_overrides(params: dict, overrides: dict) -> dict:
    """``overrides`` merged into ``params`` (a new tree; ``params`` is left as
    it was): a module (a dict with a kernel, a weight or an adapter pair)
    replaces the one at its path whole; any other dict merges key by key."""
    out = dict(params)
    for k, v in overrides.items():
        if (isinstance(v, dict) and isinstance(out.get(k), dict)
                and not {"kernel", "weight", "a"} & set(v)):
            out[k] = apply_overrides(out[k], v)
        else:
            out[k] = v
    return out


def save_converted(params: dict, path: str) -> None:
    """A converted tree to one file (``torch.save``)."""
    torch.save(params, path)


def load_converted(path: str, device="cuda") -> dict:
    """A tree written by ``save_converted``, onto ``device``."""
    return torch.load(path, map_location=_check_device(device, "load_converted"),
                      weights_only=True)
