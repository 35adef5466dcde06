"""The training step, checkpoints and the host loop, on one card.

Counterpart of ``aha_tpu/train/trainer.py`` without a mesh. The step
differentiates ONLY the 'train'-labelled leaves (``lora.trainable_labels``):
the adapters, the projector, the lm_head and the score heads require a
gradient, the frozen leaves never do. That is what lets the trunk hold packed
int4 kernels: gradients flow THROUGH the int4 products (``int4_qlinear``) to
the adapters, and no gradient of an integer leaf is ever asked for.

A state is updated IN PLACE: ``train_step(state, batch)`` returns the same
``TrainState`` object with its trained leaves, its optimizer state and its
step advanced. Checkpoints are the port's own format (``torch.save`` of
tensors, ints and dicts): with ``labels`` only the trained leaves, the
optimizer state and the step are written, and the frozen trunk is reproduced
at resume time by whatever built it.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AhaConfig, TrainConfig
from ..models import aha
from ..models.qwen2 import site_seed
from . import lora as lora_lib
from .losses import IGNORE, LossParts, aha_loss
from .optimizer import AdamW, OptState


@dataclass
class TrainState:
    tree: dict            # {"model": params, "lora": adapters (absent without LoRA)}
    opt_state: OptState
    step: int             # micro-steps taken


def _flatten(tree, path=()):
    """(path, leaf) for every leaf of a nested dict, in insertion order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def trained_paths(labels: dict) -> list[tuple[str, ...]]:
    return [p for p, l in _flatten(labels) if l == "train"]


def trained_leaves(tree: dict, labels: dict) -> dict:
    """'a/b/c' -> leaf for every 'train'-labelled leaf of ``tree``."""
    return {"/".join(p): _get(tree, p) for p in trained_paths(labels)}


def _require_device(device, who: str) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: device cuda requested but no GPU is available "
                           "(pass device='cpu' to run on the host)")
    return device


def init_train_state(cfg: AhaConfig, train_cfg: TrainConfig, params: dict, *,
                     total_steps: int, seed: int = 0, use_lora: bool = True,
                     lora_init: dict | None = None, device="cuda"):
    """-> (state, tx, labels, lora_scale). ``params`` must already lie on
    ``device`` (the card unless the caller asks for ``"cpu"``); fresh adapters
    are built there. ``lora_init`` starts from an existing adapter tree."""
    device = _require_device(device, "init_train_state")
    first = next(leaf for _, leaf in _flatten(params))
    if first.device.type != device.type:
        raise ValueError(f"init_train_state: params lie on {first.device}, not on {device}")
    tree = {"model": params}
    scale = 0.0
    if use_lora:
        tree["lora"] = lora_init if lora_init is not None else lora_lib.init_lora(
            cfg.llm, train_cfg.lora, seed=seed + 7, device=device)
        scale = lora_lib.lora_scale(train_cfg.lora)
    labels = lora_lib.trainable_labels(params, tree.get("lora"),
                                       train_cfg.lora.finetune_modules)
    tx = AdamW(train_cfg, total_steps)
    state = TrainState(tree=tree, opt_state=tx.init(trained_leaves(tree, labels)), step=0)
    return state, tx, labels, scale


def make_train_step(cfg: AhaConfig, train_cfg: TrainConfig, tx: AdamW, labels: dict,
                    lora_scale: float, device="cuda"):
    """-> ``train_step(state, batch) -> (state, LossParts)``. Batch keys (numpy
    arrays or tensors, moved to ``device``): input_ids, attention_mask,
    labels, informative_labels, relevance_labels, and frames or frame_embeds.
    Adapter-input dropout draws fresh masks every micro-step, deterministic in
    (train_cfg.seed, step)."""
    device = _require_device(device, "make_train_step")
    weights = train_cfg.loss_weights
    paths = trained_paths(labels)

    def on_device(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if v is None:
                continue
            t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            out[k] = t.to(device)
        return out

    def forward_loss(tree: dict, batch: dict, step: int) -> LossParts:
        mask = batch.get("attention_mask")
        outs = aha.forward_train(
            tree["model"], cfg, batch["input_ids"].long(), batch.get("frames"),
            attn_mask=None if mask is None else mask.bool(),
            frame_embeds=batch.get("frame_embeds"), lora=tree.get("lora"),
            lora_scale=lora_scale, remat=train_cfg.remat_policy,
            lora_dropout=train_cfg.lora.dropout,
            dropout_seed=site_seed(train_cfg.seed + 13, step))
        return aha_loss(
            outs.logits, outs.informative_logits, outs.relevance, outs.log_variance,
            input_ids=batch["input_ids"], labels=batch.get("labels"),
            informative_labels=batch.get("informative_labels"),
            relevance_labels=batch.get("relevance_labels"), weights=weights)

    def train_step(state: TrainState, batch: dict):
        leaves = [_get(state.tree, p) for p in paths]
        # the trained leaves require a gradient for the length of the step only:
        # outside it the tree is plain tensors, as the serving path expects
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            parts = forward_loss(state.tree, on_device(batch), state.step)
            grads = torch.autograd.grad(parts.total, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        names = ["/".join(p) for p in paths]
        # a leaf the batch never reached (the projector without frames) gets zeros
        tx.update({n: torch.zeros_like(l) if g is None else g
                   for n, l, g in zip(names, leaves, grads)},
                  state.opt_state, dict(zip(names, leaves)))
        state.step += 1
        return state, parts.detach()

    return train_step


def synthetic_batch(cfg: AhaConfig, tok, rng: np.random.Generator, n_frames: int, B: int = 1):
    """A batch for smoke runs and profiles: one conversation (system, user, a
    stream of ``n_frames`` learned frames, a learned answer) repeated B times,
    so no padding; next-token labels everywhere, an informative and a
    relevance label on each frame's last token, random frames.
    -> (batch of numpy arrays, T)."""
    F = cfg.frame_num_tokens
    ids = tok.apply_chat_template([
        {"role": "system", "content": "A multimodal AI assistant watches a stream."},
        {"role": "user", "content": "narrate the key moments"},
        {"role": "stream", "num_frames": n_frames, "learn": True},
        {"role": "assistant", "content": "the subject moves through the scene.", "learn": True},
    ])
    T = len(ids)
    input_ids = np.tile(np.asarray(ids, np.int32), (B, 1))
    labels = np.full((B, T), IGNORE, np.int64)
    labels[:, :-1] = input_ids[:, 1:]
    info_labels = np.full((B, T), IGNORE, np.int64)
    rel_labels = np.full((B, T), float(IGNORE), np.float32)
    for i in range(B):
        idx = np.where(input_ids[i] == cfg.v_placeholder_id)[0][F - 1::F]
        info_labels[i, idx] = rng.integers(0, 2, len(idx))
        rel_labels[i, idx] = rng.random(len(idx))
    r = cfg.frame_resolution
    frames = rng.integers(0, 255, (B * n_frames, r, r, 3)).astype(np.uint8)
    return {"input_ids": input_ids, "attention_mask": np.ones((B, T), bool), "labels": labels,
            "informative_labels": info_labels, "relevance_labels": rel_labels,
            "frames": frames}, T


# -- checkpoints ---------------------------------------------------------------


def _step_path(ckpt_dir: str, step: int) -> str:
    return os.path.abspath(os.path.join(ckpt_dir, f"step_{step:08d}.pt"))


def _opt_payload(opt: OptState) -> dict:
    return {"count": opt.count, "mini_step": opt.mini_step, "mu": opt.mu, "nu": opt.nu,
            "acc": opt.acc}


def _save(payload, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint(ckpt_dir: str, state: TrainState, *, keep: int = 5,
                    labels: dict | None = None) -> str:
    """With ``labels``: the TRAINED leaves, the optimizer state and the step
    (the frozen trunk is the base model, rebuilt at resume time). Without:
    the whole tree. A step already on disk is left as it is: the end-of-run
    save meets the in-loop save whenever total_steps % save_steps == 0."""
    path = _step_path(ckpt_dir, state.step)
    if os.path.exists(path):
        return path
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {"opt_state": _opt_payload(state.opt_state), "step": state.step}
    if labels is None:
        payload["tree"] = state.tree
    else:
        payload["trained"] = {n: t.detach() for n, t in
                              trained_leaves(state.tree, labels).items()}
    _save(payload, path)
    for old in _checkpoints(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, old))
    return path


def _checkpoints(ckpt_dir: str) -> list[str]:
    return sorted(f for f in os.listdir(ckpt_dir) if f.startswith("step_") and f.endswith(".pt"))


def latest_checkpoint(ckpt_dir: str) -> str | None:
    if not os.path.isdir(ckpt_dir):
        return None
    found = _checkpoints(ckpt_dir)
    return os.path.join(ckpt_dir, found[-1]) if found else None


def restore_checkpoint(path: str, state: TrainState, labels: dict | None = None) -> TrainState:
    """Restore into ``state`` IN PLACE: a trained-only checkpoint is merged
    over the live tree (the frozen trunk is kept as the caller built it), a
    whole-tree checkpoint replaces every leaf. Tensors land on the device of
    the leaves they replace."""
    device = next(leaf for _, leaf in _flatten(state.tree)).device
    payload = torch.load(path, map_location=device, weights_only=True)
    if "trained" in payload:
        if labels is None:
            raise ValueError(f"{path} holds trained leaves only; pass the labels it was "
                             "saved with")
        live = trained_leaves(state.tree, labels)
        if set(live) != set(payload["trained"]):
            raise ValueError(f"{path}: trained leaves differ from the state's: "
                             f"{sorted(set(live) ^ set(payload['trained']))}")
        with torch.no_grad():
            for name, leaf in live.items():
                leaf.copy_(payload["trained"][name])
    else:
        state.tree = payload["tree"]
    state.opt_state = OptState(**payload["opt_state"])
    state.step = int(payload["step"])
    return state


def export_adapter(path: str, state: TrainState, labels: dict) -> None:
    """Only the trained leaves (adapters, projector, heads, lm_head), by path."""
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    _save({n: t.detach() for n, t in trained_leaves(state.tree, labels).items()}, path)


# -- host loop -------------------------------------------------------------------


class MetricLogger:
    """JSONL metrics log, one record per logged step."""

    def __init__(self, output_dir: str):
        os.makedirs(output_dir, exist_ok=True)
        self.path = os.path.join(output_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, parts: LossParts, extra: dict | None = None) -> None:
        rec = {
            "step": step,
            "time": time.time(),
            "train/total_loss": float(parts.total),
            "train/lm_loss": float(parts.lm),
            "train/video_loss": float(parts.video),
            "train/info_loss": float(parts.info),
            "train/ref_loss": float(parts.relevance),
            "train/tv_loss": float(parts.tv),
            "train/uncertainty_loss": float(parts.uncertainty),
            **(extra or {}),
        }
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def train(cfg: AhaConfig, train_cfg: TrainConfig, params: dict, batches, *, total_steps: int,
          use_lora: bool = True, lora_init: dict | None = None, log_every: int | None = None,
          device="cuda") -> TrainState:
    """``aha_tpu/train/trainer.py::train`` on one card: resume if
    ``train_cfg.resume_from_checkpoint`` says so (the trained leaves, the
    optimizer state and the step merged over the tree the caller built), then
    one micro-step a batch of ``batches`` until ``total_steps`` micro-steps
    are taken or the batches end, with trained-only checkpoints every
    ``save_steps``, a last one (which meets the in-loop one when
    ``total_steps % save_steps == 0``) and the exported adapter
    (``adapter.pt``) under ``train_cfg.output_dir``. Every ``log_every``
    (default ``logging_steps``) micro-steps a line of ``metrics.jsonl`` holds
    the loss parts, as JAX's does, and the step's wall time, the time the step
    waited for its batch and the batch's real (unpadded) tokens."""
    state, tx, labels, scale = init_train_state(
        cfg, train_cfg, params, total_steps=total_steps, seed=train_cfg.seed,
        use_lora=use_lora, lora_init=lora_init, device=device)
    if train_cfg.resume_from_checkpoint:
        restore_checkpoint(train_cfg.resume_from_checkpoint, state, labels)
    step_fn = make_train_step(cfg, train_cfg, tx, labels, scale, device=device)
    ckpt_dir = os.path.join(train_cfg.output_dir, "checkpoints")
    logger = MetricLogger(train_cfg.output_dir)
    try:
        batches = iter(batches)
        while state.step < total_steps:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            state, parts = step_fn(state, batch)
            if state.step % (log_every or train_cfg.logging_steps) == 0:
                float(parts.total)            # the step's work is done when its loss is read
                mask = batch.get("attention_mask")
                tokens = int(np.asarray(mask).sum()) if mask is not None else int(
                    np.asarray(batch["input_ids"]).size)
                logger.log(state.step, parts, {"perf/step_ms": (time.perf_counter() - t1) * 1e3,
                                               "perf/wait_ms": (t1 - t0) * 1e3,
                                               "perf/tokens": tokens})
            if train_cfg.save_steps and state.step % train_cfg.save_steps == 0:
                save_checkpoint(ckpt_dir, state, keep=train_cfg.save_total_limit, labels=labels)
        save_checkpoint(ckpt_dir, state, keep=train_cfg.save_total_limit, labels=labels)
        export_adapter(os.path.join(train_cfg.output_dir, "adapter.pt"), state, labels)
    finally:
        logger.close()
    return state
