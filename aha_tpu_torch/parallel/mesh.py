"""Device mesh and sharding rules over ``torch.distributed``: the port's copy
of ``aha_tpu/parallel/mesh.py``.

A ``Mesh(data, model[, pipe])`` maps ranks to coordinates in JAX's order,
``np.arange(world).reshape(data, model[, pipe])``, so a ``PartitionSpec``
names the same owner in both packages, and holds one ``comm.Comm`` per axis
(the ranks that share every other coordinate). The rule table, ``_guard``,
``spec_for``, ``_pipe_stacked`` and ``param_specs`` are JAX's, leaf for leaf:

  * attention q/k/v and mlp gate/up kernels: output over ``model``, input over
    ``data``; o/down: input over ``model``, output over ``data``;
  * embed: vocabulary over ``model``, hidden over ``data``; lm_head: hidden
    over ``data``, vocabulary over ``model``;
  * LoRA ``a`` [L, in, r] / ``b`` [L, r, out]: the large dimension over ``data``;
  * norms, biases, heads: replicated; every rule divisibility-guarded.

Placement (``apply_named_sharding``) keeps on each rank only its block of a
sharded leaf, contiguous, so the hand-written kernels take it as they take a
whole leaf; the forward gathers and reduces explicitly
(``parallel/sharded.py``). ``cache_specs`` is JAX's: K/V heads over ``model``
and rows over ``data``, metadata rows over ``data``. The engine places K/V by
it and keeps the metadata ([B, W+1] int32, a few KB) on every rank whole, so
that every rank plans every row's update and takes the same host decisions.
"""

from __future__ import annotations

import numpy as np
import torch


class P(tuple):
    """A PartitionSpec: one mesh axis name (or None) per dimension."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple(self)!r}"


class RanksError(ValueError):
    """The process group's world is not the mesh's size (the port's
    counterpart of JAX's device-count assertion in ``make_mesh``)."""


class Mesh:
    """Ranks on a (data, model[, pipe]) grid, JAX's row-major order.

    ``rank`` is this process's global rank; ``comms`` one ``Comm`` per axis,
    built when the process group is up (``groups=True``) and the world has the
    mesh's size; without them the mesh only names shapes (``param_specs``)."""

    def __init__(self, data: int, model: int, pipe: int = 1, *, rank: int = 0,
                 groups: bool = True):
        self.axis_names = ("data", "model", "pipe") if pipe > 1 else ("data", "model")
        dims = (data, model, pipe) if pipe > 1 else (data, model)
        self.shape = dict(zip(self.axis_names, dims))
        self.size = data * model * pipe
        self.devices = np.arange(self.size).reshape(dims)
        self.rank = rank
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.argwhere(self.devices == rank)[0])))
        self.comms = {}
        if groups and self.size > 1:
            self._build_groups()

    def _build_groups(self):
        import torch.distributed as dist

        from .comm import Comm

        backend = dist.get_backend()
        for ax_i, ax in enumerate(self.axis_names):
            moved = np.moveaxis(self.devices, ax_i, -1).reshape(-1, self.shape[ax])
            for ranks in moved:          # every rank creates every group, in one order
                ranks = [int(r) for r in ranks]
                group = dist.new_group(ranks) if len(ranks) < self.size else dist.group.WORLD
                if self.rank in ranks:
                    self.comms[ax] = Comm(group, ranks, ranks.index(self.rank), backend)

    def comm(self, axis: str):
        """The Comm of ``axis``, or None where the axis is absent or of size 1."""
        if self.shape.get(axis, 1) == 1:
            return None
        return self.comms.get(axis)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def __repr__(self):
        return f"Mesh({self.shape}, rank={self.rank})"


def make_mesh(data: int = -1, model: int = 1, pipe: int = 1, devices=None) -> Mesh:
    """(data, model) mesh, plus a trailing ``pipe`` axis when pipe > 1, over
    the process group's world (or ``devices``: a count or a list, for a mesh
    that only names shapes). Raises where the world does not have the mesh's
    size, naming the ranks the mesh needs."""
    import torch.distributed as dist

    up = dist.is_available() and dist.is_initialized()
    if devices is not None:
        n = devices if isinstance(devices, int) else len(devices)
    else:
        n = dist.get_world_size() if up else 1
    if data == -1:                     # every rank the other axes leave
        data = max(n // (model * pipe), 1)
    need = data * model * pipe
    if need != n:
        shape = f"{data}x{model}" + (f"x{pipe}" if pipe > 1 else "")
        raise RanksError(f"mesh {shape} needs {need} ranks; start it with torchrun "
                         f"--nproc_per_node {need} (the world has {n})")
    rank = dist.get_rank() if up and devices is None else 0
    return Mesh(data, model, pipe, rank=rank, groups=up and devices is None)


def _guard(spec: P, shape: tuple[int, ...], mesh: Mesh) -> P:
    """Truncate/pad the spec to the array rank and drop axis assignments
    whose mesh size does not divide the dim."""
    entries = (tuple(spec) + (None,) * len(shape))[: len(shape)]
    out = []
    for dim, axis in zip(shape, entries):
        if axis is None:
            out.append(None)
        else:
            size = mesh.shape[axis]
            out.append(axis if dim % size == 0 else None)
    return P(*out)


# path-suffix -> desired spec for stacked decoder/vision kernels.
# Layer-stacked kernels are [L, in, out]; L is never sharded (scan axis).
_KERNEL_RULES: list[tuple[tuple[str, ...], P]] = [
    (("q_proj", "kernel"), P(None, "data", "model")),
    (("k_proj", "kernel"), P(None, "data", "model")),
    (("v_proj", "kernel"), P(None, "data", "model")),
    (("o_proj", "kernel"), P(None, "model", "data")),
    (("out_proj", "kernel"), P(None, "model", "data")),
    (("gate_proj", "kernel"), P(None, "data", "model")),
    (("up_proj", "kernel"), P(None, "data", "model")),
    (("down_proj", "kernel"), P(None, "model", "data")),
    (("fc1", "kernel"), P(None, "data", "model")),
    (("fc2", "kernel"), P(None, "model", "data")),
    (("embed", "weight"), P("model", "data")),
    (("lm_head", "kernel"), P("data", "model")),
    # non-stacked projector kernels [in, out]
    (("projector", "fc1", "kernel"), P("data", "model")),
    (("projector", "fc2", "kernel"), P("model", "data")),
    (("pos_embed",), P(None, "data")),
    (("patch_embed", "kernel"), P()),
]


def spec_for(path_keys: tuple[str, ...], shape: tuple[int, ...]) -> P:
    # quantized kernels nest {"qvalue","scale"} / {"q4value","scale4"} under
    # the kernel key: inherit the kernel's rule; the guard keeps the axis
    # assignments that still divide the scales' shapes
    if path_keys and path_keys[-1] in ("qvalue", "scale", "q4value", "scale4"):
        return spec_for(path_keys[:-1], shape)
    # longest suffix wins (projector/fc1/kernel beats fc1/kernel)
    for suffix, spec in sorted(_KERNEL_RULES, key=lambda r: -len(r[0])):
        if path_keys[-len(suffix):] == suffix:
            return spec
    # lora adapter pairs: a [L, in, r] / b [L, r, out] — shard the big dim
    if len(path_keys) >= 2 and path_keys[-1] in ("a", "b") and len(shape) == 3:
        return P(None, "data", None) if path_keys[-1] == "a" else P(None, None, "data")
    return P()  # norms, biases, heads: replicated


def _pipe_stacked(path_keys: tuple[str, ...]) -> bool:
    """Leaves whose leading [L, ...] axis shards over 'pipe': the decoder
    layer stack and the (stacked) LoRA adapters; the vision tower stays
    outside the pipeline."""
    if "vision" in path_keys:
        return False
    if "layers" in path_keys:
        return True
    return "lora" in path_keys and path_keys[-1] in ("a", "b")


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(np.shape(leaf))


def map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(tree: dict, mesh: Mesh, *, prefix: tuple[str, ...] = ()) -> dict:
    """P tree for a param / optimizer-state tree (divisibility-guarded). With a
    'pipe' axis, decoder-stack leaves also shard their leading layer axis over
    it. ``prefix``: the keys above ``tree`` in the whole tree (a LoRA tree
    passed alone is ``("lora",)``)."""
    has_pipe = "pipe" in mesh.axis_names and mesh.shape["pipe"] > 1

    def one(path, leaf):
        keys = prefix + path
        shape = _shape(leaf)
        spec = spec_for(keys, shape)
        if has_pipe and shape and _pipe_stacked(keys):
            entries = list((tuple(spec) + (None,) * len(shape))[: len(shape)])
            entries[0] = "pipe"
            spec = P(*entries)
        return _guard(spec, shape, mesh)

    return map_with_path(one, tree)


def local_block(t: torch.Tensor, spec: P, mesh: Mesh) -> torch.Tensor:
    """This rank's block of a whole leaf, contiguous and its own memory."""
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n = mesh.shape[axis]
        size = t.shape[dim] // n
        t = t.narrow(dim, mesh.index(axis) * size, size)
    return t.contiguous().clone() if any(spec) else t


def local_shape(shape: tuple[int, ...], spec: P, mesh: Mesh) -> tuple[int, ...]:
    return tuple(d // mesh.shape[a] if a is not None else d
                 for d, a in zip(shape, tuple(spec) + (None,) * len(shape)))


def apply_named_sharding(tree: dict, mesh: Mesh, specs: dict | None = None) -> dict:
    """Every leaf reduced to this rank's block of it (``specs`` default to
    ``param_specs``)."""
    specs = specs if specs is not None else param_specs(tree, mesh)

    def visit(node, sp):
        if isinstance(node, dict):
            return {k: visit(v, sp[k]) for k, v in node.items()}
        return local_block(node, sp, mesh)

    return visit(tree, specs)


def cache_specs(cache, mesh: Mesh) -> dict:
    """Specs of a KVCache's fields: kv heads over ``model``, batch over
    ``data``, metadata along batch; int8 scales like k/v (JAX's rules)."""

    def g(spec, arr):
        return None if arr is None else _guard(spec, _shape(arr), mesh)

    return {
        "k": g(P(None, "data", None, "model", None), cache.k),
        "v": g(P(None, "data", None, "model", None), cache.v),
        "key_pos": g(P("data", None), cache.key_pos),
        "order": g(P("data", None), cache.order),
        "seen": g(P("data"), cache.seen),
        "length": g(P("data"), cache.length),
        "k_scale": g(P(None, "data", None, "model"), cache.k_scale),
        "v_scale": g(P(None, "data", None, "model"), cache.v_scale),
    }


def shard_cache(cache, mesh: Mesh, *, local: bool = False):
    """K/V (and their int8 scales) reduced to this rank's rows and heads by
    ``cache_specs`` (``local``: they already are); the metadata stays whole on
    every rank. The rows a rank holds are recorded as ``cache.rows`` (None: all
    of them)."""
    B = cache.order.shape[0]
    if not local:
        specs = cache_specs(cache, mesh)
        for name in ("k", "v", "k_scale", "v_scale"):
            t = getattr(cache, name)
            if t is not None:
                setattr(cache, name, local_block(t, specs[name], mesh))
    if cache.k.shape[1] != B:
        n = cache.k.shape[1]
        cache.rows = (mesh.index("data") * n, (mesh.index("data") + 1) * n)
    return cache


def batch_spec() -> P:
    return P("data")


def data_axis_spans_processes(mesh: Mesh) -> bool:
    """True when every process owns an equal contiguous block of the data
    axis. One process per rank: a data row's ranks are processes of their own,
    so this holds when the data axis is the only one over 1, or its rows are
    whole per process, which with one rank a process means model * pipe == 1."""
    return mesh.size == 1 or mesh.size == mesh.shape["data"]


def local_rows(n: int, mesh: Mesh) -> tuple[int, int] | None:
    """The rows [r0, r1) of a global batch of ``n`` that this rank's data
    coordinate owns, or None where the data axis does not divide ``n`` (then
    every data rank holds every row)."""
    d = mesh.shape.get("data", 1)
    if d == 1 or n % d:
        return None
    per = n // d
    i = mesh.index("data")
    return i * per, (i + 1) * per


def shard_batch(batch: dict, mesh: Mesh, *, per_host: bool = False,
                placeholder: int | None = None, frame_tokens: int = 1) -> dict:
    """This rank's rows of a host batch dict. ``per_host=False``: ``batch`` is
    the whole global batch (every process loaded the same one) and its rows
    are split over ``data``; ``per_host=True``: ``batch`` already holds only
    this process's rows. Frames follow their rows: row-major, one frame per
    ``frame_tokens`` placeholder ids (``placeholder``) of a row."""
    batch = {k: v for k, v in batch.items() if v is not None}
    if per_host:
        return batch
    ids = np.asarray(batch["input_ids"])
    rows = local_rows(ids.shape[0], mesh)
    if rows is None:
        return batch
    r0, r1 = rows
    out = {k: v[r0:r1] for k, v in batch.items() if k not in ("frames", "frame_embeds")}
    for k in ("frames", "frame_embeds"):
        if k in batch:
            per_row = (ids == placeholder).sum(axis=1) // frame_tokens
            starts = np.concatenate([[0], np.cumsum(per_row)])
            out[k] = batch[k][int(starts[r0]):int(starts[r1])]
    return out
