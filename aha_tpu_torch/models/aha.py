"""The Aha model's vision path, projector and score heads, the full-sequence
training forward, plus seeded synthetic params built on the device.

Counterpart of ``aha_tpu/models/aha.py`` (``encode_vision_tokens``,
``project_features``, ``visual_embed``, ``joint_embed``, ``apply_heads``,
``forward_train``), of the heads in
``aha_tpu/streaming/engine_core.py::_scores_from_hidden``, and of
``aha_tpu/models/loader.py::materialize_random_params`` (``random_params``).
Both towers of JAX's config are here: SigLIP (``models/siglip.py``; with
``frame_token_cls`` its MAP probe gives the CLS token) and CLIP
(``models/clip.py``; its own CLS token).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..config import AhaConfig
from ..ops.pooling import pool_patch_tokens
from ..ops.preprocess import device_letterbox
from . import clip, qwen2, siglip

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


def project_features(params: dict, feats: torch.Tensor,
                     backend: str = "fused", sh=None) -> torch.Tensor:
    """llava mlp2x_gelu projector: Linear -> exact GELU (f32) -> Linear.
    ``sh``: the whole tree's specs on a mesh (fc1 column-, fc2 row-parallel)."""
    p = params["projector"]
    return siglip.mlp(feats, p, lambda y: F.gelu(y.float()).to(feats.dtype), backend,
                      None if sh is None else sh.sub("projector"))


def encode_vision_tokens(params: dict, cfg: AhaConfig, frames: torch.Tensor,
                         dtype: torch.dtype, backend: str = "fused", sh=None) -> torch.Tensor:
    """frames [N, H, W, 3] of any size -> pooled features [N, F, Hv], the CLS
    token first where ``frame_token_cls`` (F = ``cfg.frame_num_tokens``):
    CLIP's own CLS token, or SigLIP's MAP probe over its patches (the tree
    must carry ``vision/head``). ``backend``: the kernels of a quantised
    tower's products. ``sh``: the whole tree's specs on a mesh."""
    vsh = None if sh is None else sh.sub("vision")
    if tuple(frames.shape[1:3]) != (cfg.frame_resolution, cfg.frame_resolution):
        frames = device_letterbox(frames, cfg.frame_resolution)
    if cfg.vision.arch == "clip":
        pixels = clip.preprocess_frames(frames, dtype)
        tokens = clip.forward(params["vision"], cfg.vision, pixels, backend, vsh)  # [N, 1+P, Hv]
        cls_tok, spatial = tokens[:, :1], tokens[:, 1:]
    else:
        pixels = siglip.preprocess_frames(frames, dtype)
        spatial = siglip.forward(params["vision"], cfg.vision, pixels, backend, vsh)
        cls_tok = None
        if cfg.frame_token_cls:
            head = params["vision"].get("head")
            if head is None:
                raise ValueError("frame_token_cls with the SigLIP tower needs the MAP probe "
                                 "head's params (vision/head: vision.use_head at init, or a "
                                 "checkpoint carrying vision_model.head.*)")
            if vsh is not None:          # the probe head is small: read whole
                head = _whole(head, vsh.sub("head"))
            cls_tok = siglip.attention_pool(head, cfg.vision, spatial, backend)[:, None]
    feats = pool_patch_tokens(spatial, cfg.vision.grid_size, cfg.frame_token_pooled,
                              cfg.pooling_mode)
    if cfg.frame_token_cls:
        feats = torch.cat([cls_tok.to(feats.dtype), feats], dim=1)
    return feats


def _whole(tree, sh):
    if isinstance(tree, dict):
        return {k: _whole(v, sh.sub(k)) for k, v in tree.items()}
    return sh.whole(tree, sh.specs)


def visual_embed(params: dict, cfg: AhaConfig, frames: torch.Tensor,
                 backend: str = "fused", sh=None) -> torch.Tensor:
    """frames [N, H, W, 3] (uint8 or float pixels) -> [N, F, H_llm]. The
    tower runs in the dtype of a dense projector kernel (f32 behind a peft
    artifact's projector, as in JAX), else in ``cfg.dtype``; ``backend``
    serves the tower's quantised products and the projector's."""
    k = params["projector"]["fc1"]["kernel"]
    dtype = torch_dtype(cfg.dtype) if isinstance(k, dict) else k.dtype
    feats = encode_vision_tokens(params, cfg, frames, dtype, backend, sh)
    return project_features(params, feats, backend, sh)


def scores_from_hidden(params: dict, hidden_last: torch.Tensor) -> torch.Tensor:
    """[..., H] -> [..., 3] f32: softmax(informative)[1], sigmoid(relevance),
    exp(log-variance)."""
    hf = hidden_last.float()
    heads = params["heads"]
    info = hf @ heads["informative"]["kernel"].float()
    rel = hf @ heads["relevance"]["kernel"].float()
    unc = hf @ heads["uncertainty"]["kernel"].float()
    return torch.stack([torch.softmax(info, dim=-1)[..., 1],
                        torch.sigmoid(rel[..., 0]), torch.exp(unc[..., 0])], dim=-1)


@dataclass
class AhaOutputs:
    """Per-token outputs of the full-sequence forward."""

    logits: torch.Tensor              # [B, T, V] f32
    informative_logits: torch.Tensor  # [B, T, 2] f32
    relevance: torch.Tensor           # [B, T] f32, sigmoid applied
    log_variance: torch.Tensor        # [B, T] f32
    hidden: torch.Tensor              # [B, T, H]


def joint_embed(params: dict, cfg: AhaConfig, input_ids: torch.Tensor,
                frame_embeds: torch.Tensor | None, sh=None) -> torch.Tensor:
    """Token embeddings [B, T, H] with the projected frame tokens
    ``frame_embeds`` [N, H] at the ``<image>`` placeholder positions: the k-th
    placeholder (row-major over the batch) takes frame token k."""
    embeds = qwen2.embed_tokens(params["llm"], input_ids.clamp(0, cfg.llm.vocab_size - 1),
                                torch_dtype(cfg.dtype), None if sh is None else sh.sub("llm"))
    if frame_embeds is None:
        return embeds
    B, T = input_ids.shape
    mask = input_ids.reshape(-1) == cfg.v_placeholder_id
    visual_idx = (torch.cumsum(mask, dim=0) - 1).clamp(0, frame_embeds.shape[0] - 1)
    gathered = frame_embeds[visual_idx].to(embeds.dtype)
    return torch.where(mask[:, None], gathered, embeds.reshape(B * T, -1)).reshape(B, T, -1)


def apply_heads(params: dict, cfg: AhaConfig, hidden: torch.Tensor,
                backend: str = "fused", sh=None) -> AhaOutputs:
    hf = hidden.float()
    if cfg.video_head_stop_grad:
        # ablation: the video losses train the head kernels only, never the trunk
        hf = hf.detach()
    heads = params["heads"]
    rel = hf @ heads["relevance"]["kernel"].float()
    unc = hf @ heads["uncertainty"]["kernel"].float()
    return AhaOutputs(
        logits=qwen2.lm_logits(params["llm"], cfg.llm, hidden, backend,
                               None if sh is None else sh.sub("llm")).float(),
        informative_logits=hf @ heads["informative"]["kernel"].float(),
        relevance=torch.sigmoid(rel[..., 0]),
        log_variance=unc[..., 0],
        hidden=hidden)


def forward_train(params: dict, cfg: AhaConfig, input_ids: torch.Tensor,
                  frames: torch.Tensor | None, *, attn_mask: torch.Tensor | None = None,
                  frame_embeds: torch.Tensor | None = None, lora: dict | None = None,
                  lora_scale: float = 0.0, remat: bool | str = True,
                  lora_dropout: float = 0.0, dropout_seed: int | None = None,
                  backend: str = "fused", sh=None, lora_sh=None, ring=None,
                  pipe=None) -> AhaOutputs:
    """The full-sequence forward of training and offline evaluation.
    ``frames`` [N, H, W, 3] are encoded here (the frozen tower without a
    graph, the projector with one); ``frame_embeds`` [N, F, H] or [N * F, H]
    are projected features extracted beforehand. Pass one or neither. In a
    left-padded batch (``attn_mask`` [B, T] bool) positions start at 0 on a
    row's first real token.

    On a mesh: ``sh`` / ``lora_sh`` (``parallel.sharded.Shard`` of the tree's
    and the adapters' specs, ``sh.rows`` where the batch holds the rank's
    rows), ``ring`` = (mesh, axis): the batch holds every row and each rank
    runs its stretch of the tokens (``sh.seq``), whose outputs are returned;
    ``pipe`` = (mesh, axis, n_micro): GPipe stages (``qwen2.forward_hidden``)."""
    if frames is not None:
        if frame_embeds is not None:
            raise ValueError("pass frames or frame_embeds, not both")
        k = params["projector"]["fc1"]["kernel"]
        dtype = torch_dtype(cfg.dtype) if isinstance(k, dict) else k.dtype
        with torch.no_grad():
            feats = encode_vision_tokens(params, cfg, frames, dtype, backend, sh)
        frame_embeds = project_features(params, feats, backend, sh)
    if frame_embeds is not None:
        frame_embeds = frame_embeds.reshape(-1, frame_embeds.shape[-1])
    embeds = joint_embed(params, cfg, input_ids, frame_embeds, sh)
    positions = None
    if attn_mask is not None:
        positions = (torch.cumsum(attn_mask.int(), dim=1) - 1).clamp(min=0)
    if ring is not None:
        t0, T = sh.seq
        t1 = t0 + T // sh.mesh.shape[ring[1]]
        if positions is None:
            positions = torch.arange(T, device=embeds.device)[None].expand(embeds.shape[0], T)
        embeds, positions = embeds[:, t0:t1], positions[:, t0:t1]
        attn_mask = None if attn_mask is None else attn_mask[:, t0:t1]
    hidden = qwen2.forward_hidden(
        params["llm"], cfg.llm, embeds, attn_mask=attn_mask, positions=positions, lora=lora,
        lora_scale=lora_scale, remat=remat, lora_dropout=lora_dropout,
        dropout_seed=dropout_seed, backend=backend,
        sh=None if sh is None else sh.sub("llm"), lora_sh=lora_sh, ring=ring, pipe=pipe)
    return apply_heads(params, cfg, hidden, backend, sh)


def random_params(cfg: AhaConfig, *, mode: str = "int8", keep_dense: tuple[str, ...] = (),
                  device="cuda", seed: int = 0) -> dict:
    """Synthetic params of a quantized deployment config, built leaf by leaf
    on ``device`` in their final dtype, with the recipe of
    ``loader.materialize_random_params(cfg, mode)``: dense kernels
    normal(0, 0.02), norms one, biases zero, and

      * ``mode="int8"``: int8 values uniform in [-127, 127], scales 0.02/127;
      * ``mode="int4"``: packed nibble bytes uniform in 0..255, bf16 group
        scales 0.02/7, group 128 (the whole of K where 128 does not divide
        it).

    Every decoder projection (merged qkv / gate_up, the layout the engine
    serves), the projector and the lm_head are quantized in ``mode``; the
    embedding table is int8 with per-row scales in both; the vision tower
    (SigLIP with its MAP probe where ``frame_token_cls``, or CLIP) and the
    heads stay dense. ``keep_dense`` names the modules of
    ``("projector", "lm_head")`` to leave dense instead: QLoRA trains both
    densely over the frozen quantized trunk
    (``quantize_params(keep_dense=("projector", "lm_head"))``).
    Deterministic for a seed, not bit-equal to JAX's PRNG. Runs on the card
    unless ``device`` says otherwise."""
    if mode not in ("int8", "int4"):
        raise ValueError(f"random_params: mode must be 'int8' or 'int4', got {mode!r}")
    if not set(keep_dense) <= {"projector", "lm_head"}:
        raise ValueError(f"random_params: keep_dense takes 'projector' and 'lm_head', got "
                         f"{keep_dense!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("random_params: device cuda requested but no GPU is available "
                           "(pass device='cpu' to build on the host)")
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = torch_dtype(cfg.dtype)

    def normal(*shape):
        return (torch.randn(shape, generator=gen, device=device) * 0.02).to(dt)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def kernel8(*shape, per_row=False):
        """[.., K, N] int8 with per-column scales [.., 1, N] (or, for an
        embedding table, per-row scales [V, 1])."""
        q = torch.randint(-127, 128, shape, generator=gen, device=device,
                          dtype=torch.int8)
        sshape = (*shape[:-1], 1) if per_row else (*shape[:-2], 1, shape[-1])
        return {"qvalue": q, "scale": torch.full(sshape, 0.02 / 127.0,
                                                 dtype=torch.float32, device=device)}

    def kernel4(*shape):
        """[.., K, N] as packed nibbles [.., K/2, N] + bf16 group scales."""
        *lead, K, N = shape
        G = 128 if K % 128 == 0 else K
        q = torch.randint(0, 256, (*lead, K // 2, N), generator=gen, device=device,
                          dtype=torch.uint8)
        return {"q4value": q, "scale4": torch.full((*lead, K // G, N), 0.02 / 7.0,
                                                   dtype=torch.bfloat16, device=device)}

    kernel = kernel8 if mode == "int8" else kernel4
    head_kernel = normal if "lm_head" in keep_dense else kernel
    proj_kernel = normal if "projector" in keep_dense else kernel

    v, q = cfg.vision, cfg.llm
    L, H, I = q.num_layers, q.hidden_size, q.intermediate_size
    QD, KD = q.q_dim, q.kv_dim
    Lv, Hv, Iv, P = v.num_layers, v.hidden_size, v.intermediate_size, v.patch_size
    def tower_layers():
        return {
            "ln1": {"scale": ones(Lv, Hv), "bias": zeros(Lv, Hv)},
            **{n: {"kernel": normal(Lv, Hv, Hv), "bias": zeros(Lv, Hv)}
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ln2": {"scale": ones(Lv, Hv), "bias": zeros(Lv, Hv)},
            "fc1": {"kernel": normal(Lv, Hv, Iv), "bias": zeros(Lv, Iv)},
            "fc2": {"kernel": normal(Lv, Iv, Hv), "bias": zeros(Lv, Hv)},
        }

    # the tower's leaves are drawn in dict order: patch kernel, position table, layers
    if v.arch == "clip":          # CLS token and pre-LN; no patch bias, no post-LN
        vision = {"cls_embed": normal(Hv), "patch_embed": {"kernel": normal(Hv, 3, P, P)},
                  "pos_embed": normal(v.num_patches + 1, Hv),
                  "pre_ln": {"scale": ones(Hv), "bias": zeros(Hv)}}
        vision["layers"] = tower_layers()
    else:
        vision = {"patch_embed": {"kernel": normal(Hv, 3, P, P), "bias": zeros(Hv)},
                  "pos_embed": normal(v.num_patches, Hv)}
        vision["layers"] = tower_layers()
        vision["post_ln"] = {"scale": ones(Hv), "bias": zeros(Hv)}
        if v.use_head or cfg.frame_token_cls:      # the MAP probe of frame_token_cls
            vision["head"] = {
                "probe": normal(1, Hv),
                **{n: {"kernel": normal(Hv, Hv), "bias": zeros(Hv)}
                   for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
                "ln": {"scale": ones(Hv), "bias": zeros(Hv)},
                "fc1": {"kernel": normal(Hv, Iv), "bias": zeros(Iv)},
                "fc2": {"kernel": normal(Iv, Hv), "bias": zeros(Hv)}}
    llm = {
        "embed": {"weight": kernel8(q.vocab_size, H, per_row=True)},
        "layers": {
            "input_norm": {"scale": ones(L, H)},
            "qkv_proj": {"kernel": kernel(L, H, QD + 2 * KD), "bias": zeros(L, QD + 2 * KD)},
            "o_proj": {"kernel": kernel(L, QD, H)},
            "post_norm": {"scale": ones(L, H)},
            "gate_up_proj": {"kernel": kernel(L, H, 2 * I)},
            "down_proj": {"kernel": kernel(L, I, H)},
        },
        "final_norm": {"scale": ones(H)},
    }
    if not q.tie_word_embeddings:
        llm["lm_head"] = {"kernel": head_kernel(H, q.vocab_size)}
    return {
        "vision": vision,
        "projector": {"fc1": {"kernel": proj_kernel(Hv, H), "bias": zeros(H)},
                      "fc2": {"kernel": proj_kernel(H, H), "bias": zeros(H)}},
        "llm": llm,
        "heads": {"informative": {"kernel": normal(H, 2)},
                  "relevance": {"kernel": normal(H, 1)},
                  "uncertainty": {"kernel": normal(H, 1)}},
    }
