"""The training step, checkpoints and the host loop, on one card or a mesh.

Counterpart of ``aha_tpu/train/trainer.py``. The step
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

On a mesh (``device_mesh``, one process a rank): the tree and the optimizer's
moments hold each rank's blocks (``parallel.mesh.param_specs``); the step runs
the rank's rows (or, with ring attention, its stretch of every row's tokens),
the loss is the global batch's (``losses.aha_loss(comm=)``), a trained leaf
replicated over ``data`` has its gradient summed over ``data`` (one sharded
over it got its sum from the gather's reduce-scatter), and clipping reads the
norm over every shard. Checkpoints are written by rank 0 as the same files
one card writes (every leaf gathered whole), so a run resumes on any mesh.
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
from ..parallel.mesh import local_block
from . import lora as lora_lib
from .losses import IGNORE, LossParts, aha_loss
from .optimizer import AdamW, OptState


@dataclass
class TrainState:
    tree: dict            # {"model": params, "lora": adapters (absent without LoRA)}
    opt_state: OptState
    step: int             # micro-steps taken
    mesh: object = None   # parallel.mesh.Mesh: the tree holds this rank's blocks
    specs: dict | None = None   # the tree's specs on the mesh


def _rank0(state) -> bool:
    return state.mesh is None or state.mesh.rank == 0


def _agreed(state, flag: bool) -> bool:
    """Rank 0's ``flag`` on every rank of the state's mesh (a decision that
    leads into collectives)."""
    if state.mesh is None:
        return flag
    from ..utils.dist import agreed_flag

    return agreed_flag(int(flag) if state.mesh.rank == 0 else 0)


def _spec_at(specs: dict, name: str):
    return _get(specs, tuple(name.split("/")))


def _whole(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """A leaf's block gathered whole (every rank gets it)."""
    for d, ax in enumerate(spec):
        if ax is not None and mesh.comm(ax) is not None:
            t = mesh.comm(ax).all_gather(t, d)
    return t


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
                     lora_init: dict | None = None, device="cuda", device_mesh=None):
    """-> (state, tx, labels, lora_scale). ``params`` must already lie on
    ``device`` (the card unless the caller asks for ``"cpu"``); fresh adapters
    are built there. ``lora_init`` starts from an existing adapter tree.
    ``device_mesh``: every rank passes the whole tree; each keeps its blocks
    (a merged decoder merges each rank's own q/k/v and gate/up blocks)."""
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
    mesh = device_mesh if device_mesh is not None and device_mesh.size > 1 else None
    specs = None
    if mesh is not None:
        from ..parallel.mesh import apply_named_sharding, param_specs
        from ..parallel.sharded import place

        merged = "qkv_proj" in params.get("llm", {}).get("layers", {})
        local, mspecs = place(params, mesh, q_dim=cfg.llm.q_dim, kv_dim=cfg.llm.kv_dim,
                              merge=merged)
        tree["model"], specs = local, {"model": mspecs}
        if "lora" in tree:
            specs["lora"] = param_specs(tree["lora"], mesh, prefix=("lora",))
            tree["lora"] = apply_named_sharding(tree["lora"], mesh, specs["lora"])
    labels = lora_lib.trainable_labels(tree["model"], tree.get("lora"),
                                       train_cfg.lora.finetune_modules)
    tx = AdamW(train_cfg, total_steps)
    state = TrainState(tree=tree, opt_state=tx.init(trained_leaves(tree, labels)), step=0,
                       mesh=mesh, specs=specs)
    return state, tx, labels, scale


def make_train_step(cfg: AhaConfig, train_cfg: TrainConfig, tx: AdamW, labels: dict,
                    lora_scale: float, device="cuda", device_mesh=None, pad_token_id: int = 0):
    """-> ``train_step(state, batch) -> (state, LossParts)``. Batch keys (numpy
    arrays or tensors, moved to ``device``): input_ids, attention_mask,
    labels, informative_labels, relevance_labels, and frames or frame_embeds.
    Adapter-input dropout draws fresh masks every micro-step, deterministic in
    (train_cfg.seed, step).

    On a mesh (the state's, made by ``init_train_state(device_mesh=)``) the
    batch is the global one every process loaded (the step takes its rows),
    or with ``train_step(state, batch, per_host=True)`` this process's rows.
    ``train_cfg.ring_attention`` runs a batch of at least ``ring_min_seq``
    tokens sequence-parallel over ``data``; ``mesh_pipe`` > 1 runs GPipe stages
    of ``pipe_microbatches`` microbatches. Both need the mesh."""
    device = _require_device(device, "make_train_step")
    weights = train_cfg.loss_weights
    paths = trained_paths(labels)
    if train_cfg.ring_attention and (device_mesh is None or device_mesh.size == 1):
        raise ValueError("ring_attention=True needs device_mesh")
    if train_cfg.mesh_pipe > 1 and (device_mesh is None or device_mesh.size == 1):
        raise ValueError("mesh_pipe>1 needs device_mesh")

    def on_device(batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            if v is None:
                continue
            t = torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
            out[k] = t.to(device)
        return out

    def forward_loss(tree: dict, batch: dict, step: int, shard=None) -> LossParts:
        mask = batch.get("attention_mask")
        sh, lora_sh, ring, pipe, comm, seq = shard or (None,) * 6
        outs = aha.forward_train(
            tree["model"], cfg, batch["input_ids"].long(), batch.get("frames"),
            attn_mask=None if mask is None else mask.bool(),
            frame_embeds=batch.get("frame_embeds"), lora=tree.get("lora"),
            lora_scale=lora_scale, remat=train_cfg.remat_policy,
            lora_dropout=train_cfg.lora.dropout,
            dropout_seed=site_seed(train_cfg.seed + 13, step),
            sh=sh, lora_sh=lora_sh, ring=ring, pipe=pipe)
        ids = batch["input_ids"]
        per_token = {k: batch.get(k) for k in ("labels", "informative_labels",
                                               "relevance_labels")}
        if seq is not None:
            t0, T = seq
            t1 = t0 + outs.relevance.shape[1]
            ids = ids[:, t0:t1]
            per_token = {k: None if v is None else v[:, t0:t1] for k, v in per_token.items()}
        return aha_loss(
            outs.logits, outs.informative_logits, outs.relevance, outs.log_variance,
            input_ids=ids, labels=per_token["labels"],
            informative_labels=per_token["informative_labels"],
            relevance_labels=per_token["relevance_labels"], weights=weights,
            comm=comm, seq=seq)

    def mesh_parts(state: TrainState, batch: dict, per_host: bool):
        """(batch for this rank, (sh, lora_sh, ring, pipe, comm, seq))."""
        from ..parallel.mesh import local_rows, shard_batch
        from ..parallel.sharded import Shard

        mesh = state.mesh
        D = mesh.shape["data"]
        ids = np.asarray(batch["input_ids"])
        B, T = ids.shape
        pipe = ((mesh, "pipe", train_cfg.pipe_microbatches)
                if mesh.shape.get("pipe", 1) > 1 else None)
        ring = None
        rows = seq = None
        comm = mesh.comm("data")
        replicated = False
        if train_cfg.ring_attention and T >= train_cfg.ring_min_seq and D > 1:
            if per_host:
                raise ValueError("ring attention reads every row on every data rank: load "
                                 "the batch replicated (per_host=False)")
            if T % D:
                raise ValueError(f"ring attention: {T} tokens not divisible by data={D}")
            ring, seq = (mesh, "data"), (mesh.index("data") * (T // D), T)
        elif D > 1:
            if per_host:
                rows = (mesh.index("data") * B, B * D)
                T_all = int(mesh.comm("data").all_reduce(
                    torch.tensor([T], device=device), "max").item())
                batch = _left_pad(batch, T_all - T, pad_token_id)
            else:
                r = local_rows(B, mesh)
                if r is None:
                    # a batch the data axis does not divide stays whole on every data
                    # rank, as JAX's shard_batch leaves it (_guard drops ``data``
                    # from its spec): each rank's loss and gradients are the whole
                    # batch's, so nothing is summed over ``data``
                    replicated, comm = True, None
                else:
                    rows = (r[0], B)
                    batch = shard_batch(batch, mesh, placeholder=cfg.v_placeholder_id,
                                        frame_tokens=cfg.frame_num_tokens)
        sh = Shard(mesh, state.specs["model"], rows=rows, seq=seq, rows_replicated=replicated)
        lora_sh = (None if "lora" not in state.specs
                   else Shard(mesh, state.specs["lora"], rows=rows, seq=seq,
                              rows_replicated=replicated))
        return batch, (sh, lora_sh, ring, pipe, comm, seq)

    def train_step(state: TrainState, batch: dict, per_host: bool = False):
        shard = None
        if state.mesh is not None:
            batch, shard = mesh_parts(state, batch, per_host)
        leaves = [_get(state.tree, p) for p in paths]
        # the trained leaves require a gradient for the length of the step only:
        # outside it the tree is plain tensors, as the serving path expects
        for leaf in leaves:
            leaf.requires_grad_(True)
        try:
            parts = forward_loss(state.tree, on_device(batch), state.step, shard)
            grads = torch.autograd.grad(parts.total, leaves, allow_unused=True)
        finally:
            for leaf in leaves:
                leaf.requires_grad_(False)
        names = ["/".join(p) for p in paths]
        # a leaf the batch never reached (the projector without frames) gets zeros
        grads = {n: torch.zeros_like(l) if g is None else g
                 for n, l, g in zip(names, leaves, grads)}
        mesh_kw = {}
        if state.mesh is not None:
            grads, mesh_kw["sq_sum"] = _reduce_grads(
                state, grads, rows_summed=not shard[0].rows_replicated)
        tx.update(grads, state.opt_state, dict(zip(names, leaves)), **mesh_kw)
        state.step += 1
        return state, parts.detach()

    return train_step


def _left_pad(batch: dict, n: int, pad_token_id: int) -> dict:
    """n more columns on the left of every per-token array: pad ids, no
    attention, no labels."""
    if n <= 0:
        return batch
    fill = {"input_ids": pad_token_id, "attention_mask": False, "labels": IGNORE,
            "informative_labels": IGNORE, "relevance_labels": float(IGNORE)}
    out = dict(batch)
    for k, v in fill.items():
        if batch.get(k) is not None:
            a = np.asarray(batch[k])
            out[k] = np.concatenate([np.full((a.shape[0], n), v, a.dtype), a], axis=1)
    return out


def _reduce_grads(state: TrainState, grads: dict, rows_summed: bool = True):
    """Sum over ``data`` the gradients of leaves replicated over it (each data
    rank differentiated its own rows; ``rows_summed=False``: every data rank
    ran the whole batch, so the gradients are whole already); -> (grads, the
    global sum of squares over every shard of every leaf)."""
    mesh = state.mesh
    data = mesh.comm("data") if rows_summed else None
    out = {}
    for n, g in grads.items():
        spec = _spec_at(state.specs, n)
        out[n] = data.all_reduce(g) if data is not None and "data" not in spec else g

    def sq_sum(gs: dict) -> torch.Tensor:
        total = None
        for n, g in gs.items():
            s = g.float().pow(2).sum()
            # in mesh order on every rank (a set's order differs between processes)
            for ax in [a for a in mesh.axis_names if a in _spec_at(state.specs, n)]:
                if mesh.comm(ax) is not None:
                    s = mesh.comm(ax).all_reduce(s)
            total = s if total is None else total + s
        return total

    return out, sq_sum


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


def _opt_payload(opt: OptState, state: TrainState | None = None) -> dict:
    whole = (lambda d: d) if state is None or state.mesh is None else (
        lambda d: {n: _whole(t, _spec_at(state.specs, n), state.mesh) for n, t in d.items()})
    return {"count": opt.count, "mini_step": opt.mini_step, "mu": whole(opt.mu),
            "nu": whole(opt.nu), "acc": whole(opt.acc)}


def _save(payload, path: str) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _trained_whole(state: TrainState, labels: dict) -> dict:
    live = trained_leaves(state.tree, labels)
    if state.mesh is None:
        return {n: t.detach() for n, t in live.items()}
    return {n: _whole(t.detach(), _spec_at(state.specs, n), state.mesh)
            for n, t in live.items()}


def save_checkpoint(ckpt_dir: str, state: TrainState, *, keep: int = 5,
                    labels: dict | None = None) -> str:
    """With ``labels``: the TRAINED leaves, the optimizer state and the step
    (the frozen trunk is the base model, rebuilt at resume time). Without:
    the whole tree. A step already on disk is left as it is: the end-of-run
    save meets the in-loop save whenever total_steps % save_steps == 0. On a
    mesh every rank gathers the leaves whole and rank 0 writes them."""
    path = _step_path(ckpt_dir, state.step)
    if _agreed(state, os.path.exists(path)):
        return path
    if state.mesh is not None and labels is None:
        raise ValueError("a sharded state saves its trained leaves: pass labels")
    payload = {"opt_state": _opt_payload(state.opt_state, state), "step": state.step}
    if labels is None:
        payload["tree"] = state.tree
    else:
        payload["trained"] = _trained_whole(state, labels)
    if _rank0(state):
        os.makedirs(ckpt_dir, exist_ok=True)
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
    the leaves they replace; on a mesh each rank takes its blocks of them."""
    device = next(leaf for _, leaf in _flatten(state.tree)).device
    payload = torch.load(path, map_location=device, weights_only=True)
    block = (lambda n, t: t) if state.mesh is None else (
        lambda n, t: local_block(t, _spec_at(state.specs, n), state.mesh))
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
                leaf.copy_(block(name, payload["trained"][name]))
    else:
        state.tree = payload["tree"]
    opt = payload["opt_state"]
    for k in ("mu", "nu", "acc"):
        opt[k] = {n: block(n, t) for n, t in opt[k].items()}
    state.opt_state = OptState(**opt)
    state.step = int(payload["step"])
    return state


def export_adapter(path: str, state: TrainState, labels: dict) -> None:
    """Only the trained leaves (adapters, projector, heads, lm_head), by path."""
    leaves = _trained_whole(state, labels)
    if _rank0(state):
        os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
        _save(leaves, path)


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
          device="cuda", device_mesh=None, per_host_batches: bool = False,
          pad_token_id: int = 0) -> TrainState:
    """``aha_tpu/train/trainer.py::train``: resume if
    ``train_cfg.resume_from_checkpoint`` says so (the trained leaves, the
    optimizer state and the step merged over the tree the caller built), then
    one micro-step a batch of ``batches`` until ``total_steps`` micro-steps
    are taken or the batches end, with trained-only checkpoints every
    ``save_steps``, a last one (which meets the in-loop one when
    ``total_steps % save_steps == 0``) and the exported adapter
    (``adapter.pt``) under ``train_cfg.output_dir``. Every ``log_every``
    (default ``logging_steps``) micro-steps a line of ``metrics.jsonl`` holds
    the loss parts, as JAX's does, and the step's wall time, the time the step
    waited for its batch and the batch's real (unpadded) tokens.

    ``device_mesh`` (default: ``train_cfg``'s mesh over the process group's
    world when it has more than one rank): every rank passes the whole tree
    and iterates its batches; ``per_host_batches``: each process's batches
    hold only its rows (left-padded with ``pad_token_id`` to the longest
    rank's). Rank 0 writes the metrics, checkpoints and adapter."""
    mesh = device_mesh
    if mesh is None:
        from ..utils.dist import process_count

        if process_count() > 1 or train_cfg.mesh_pipe > 1 or train_cfg.mesh_model > 1:
            from ..parallel.mesh import make_mesh

            mesh = make_mesh(train_cfg.mesh_data, train_cfg.mesh_model, train_cfg.mesh_pipe)
    state, tx, labels, scale = init_train_state(
        cfg, train_cfg, params, total_steps=total_steps, seed=train_cfg.seed,
        use_lora=use_lora, lora_init=lora_init, device=device, device_mesh=mesh)
    if train_cfg.resume_from_checkpoint:
        restore_checkpoint(train_cfg.resume_from_checkpoint, state, labels)
    step_fn = make_train_step(cfg, train_cfg, tx, labels, scale, device=device,
                              device_mesh=state.mesh, pad_token_id=pad_token_id)
    ckpt_dir = os.path.join(train_cfg.output_dir, "checkpoints")
    logger = MetricLogger(train_cfg.output_dir) if _rank0(state) else None
    per_host = per_host_batches and state.mesh is not None
    try:
        batches = iter(batches)
        while state.step < total_steps:
            t0 = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            t1 = time.perf_counter()
            state, parts = (step_fn(state, batch, per_host=True) if per_host
                            else step_fn(state, batch))
            if state.step % (log_every or train_cfg.logging_steps) == 0:
                float(parts.total)            # the step's work is done when its loss is read
                mask = batch.get("attention_mask")
                tokens = int(np.asarray(mask).sum()) if mask is not None else int(
                    np.asarray(batch["input_ids"]).size)
                if logger is not None:
                    logger.log(state.step, parts,
                               {"perf/step_ms": (time.perf_counter() - t1) * 1e3,
                                "perf/wait_ms": (t1 - t0) * 1e3, "perf/tokens": tokens})
            if train_cfg.save_steps and state.step % train_cfg.save_steps == 0:
                save_checkpoint(ckpt_dir, state, keep=train_cfg.save_total_limit, labels=labels)
        save_checkpoint(ckpt_dir, state, keep=train_cfg.save_total_limit, labels=labels)
        export_adapter(os.path.join(train_cfg.output_dir, "adapter.pt"), state, labels)
    finally:
        if logger is not None:
            logger.close()
    return state
