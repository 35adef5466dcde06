"""The forward of a rank that holds its blocks of a mesh-placed tree.

JAX's sharded forward is the one-device forward under ``NamedSharding``
annotations, GSPMD deriving every collective. Here a ``Shard`` carries the
mesh and the tree's specs (``mesh.param_specs``), and the model functions ask
it for each product:

  * a leaf sharded over ``data`` is gathered at use, layer by layer
    (``fsdp_gather``: its gradient reduce-scattered back to the owners), and
    the gathered copy lives only as long as the product that reads it;
  * a kernel whose output is split over ``model`` is a column-parallel
    product (its activations enter through ``copy_to``), one whose input is
    split a row-parallel product whose partial sums are all-reduced
    (``reduce_from``); biases are replicated, and each rank adds its slice;
  * a quantized kernel is split only where all of its parts are split on the
    same dimension in whole groups (an int4 kernel whose groups a rank would
    cut, an int8 scale that cannot follow): otherwise the leaf is gathered
    over ``model`` first and the product runs whole, as is an activation that
    a product needs whole.

``linear`` returns the output and whether it is split over ``model``; the
attention runs on local heads when every kv head stays whole on a rank and
gathers q/k/v over ``model`` otherwise (``heads_local``).

Row and sequence regions: ``rows`` = (first row, global rows) where a rank
holds some rows of the batch, ``seq`` = (first token, global length) where it
holds a stretch of each sequence (ring attention). Adapter dropout draws its
mask on the global shape and takes the rank's part, so a sharded step drops
what the one-rank step drops. ``rows_replicated``: every data rank holds every
row (a global batch the data axis does not divide, as JAX's ``shard_batch``
leaves it), so a leaf gathered over ``data`` takes its own chunk of the
gradient, which each rank holds whole, instead of the sum over the ranks.
"""

from __future__ import annotations

import copy
import dataclasses

import torch

from . import comm as C


def layer_specs(specs):
    """One layer's spec tree of a layer-stacked spec subtree ([L, ...] -> [...])."""
    if isinstance(specs, dict):
        return {k: layer_specs(v) for k, v in specs.items()}
    return tuple(specs)[1:]


def _dims(spec, axis):
    return [d for d, a in enumerate(spec) if a == axis]


class Shard:
    """One rank's view of a placed tree: ``mesh``, ``specs`` (the spec tree of
    the subtree the model function reads), the row and sequence regions."""

    def __init__(self, mesh, specs, *, rows=None, seq=None, rows_replicated=False):
        self.mesh, self.specs = mesh, specs
        self.data = mesh.comm("data")
        self.model = mesh.comm("model")
        self.pipe = mesh.comm("pipe")
        self.M = mesh.shape.get("model", 1)
        self.mi = mesh.index("model")
        self.rows, self.seq = rows, seq
        self.rows_replicated = rows_replicated

    def sub(self, *keys) -> "Shard":
        sp = self.specs
        for k in keys:
            sp = sp[k]
        return self._with(sp)

    def _with(self, specs, **kw) -> "Shard":
        s = copy.copy(self)
        s.specs = specs
        s.__dict__.update(kw)
        return s

    def layer(self) -> "Shard":
        """The per-layer view of a layer-stacked subtree's specs."""
        return self._with(layer_specs(self.specs))

    def region(self, **kw) -> "Shard":
        return self._with(self.specs, **kw)

    # -- leaves ------------------------------------------------------------------------

    def gather_data(self, t, spec):
        """Gather the dims of ``t`` sharded over ``data``; returns (t, spec without data)."""
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        for d in _dims(spec, "data"):
            t = C.fsdp_gather(t, self.data, d, summed=not self.rows_replicated)
        return t, tuple(None if a == "data" else a for a in spec)

    def gather_model(self, t, spec):
        spec = tuple(spec) + (None,) * (t.dim() - len(spec))
        for d in _dims(spec, "model"):
            t = C.gather_from(t, self.model, d)
        return t, tuple(None if a == "model" else a for a in spec)

    def whole(self, t, spec):
        """A leaf gathered over every axis (a small leaf read whole)."""
        t, spec = self.gather_data(t, spec)
        return self.gather_model(t, spec)[0]

    def kernel(self, k, ksp):
        """A kernel (dense or quantized dict) gathered over ``data``, then
        -> (kernel, layout): layout "out" (columns split over ``model``),
        "in" (rows split) or None (whole; parts that could not follow the
        split are gathered over ``model`` too)."""
        if not isinstance(k, dict):
            k, sp = self.gather_data(k, ksp)
            if sp[-1] == "model":
                return k, "out"
            if len(sp) > 1 and sp[-2] == "model":
                return k, "in"
            return k, None
        parts, sps = {}, {}
        for n, t in k.items():
            parts[n], sps[n] = self.gather_data(t, ksp[n])
        main = "q4value" if "q4value" in parts else "qvalue"
        msp = sps[main]
        layout = "out" if msp[-1] == "model" else "in" if msp[-2] == "model" else None
        sc = "scale4" if main == "q4value" else "scale"
        ssp = sps[sc]
        if layout == "out" and ssp[-1] != "model":
            layout = "mixed"
        if layout == "in" and main == "q4value" and ssp[-2] != "model":
            layout = "mixed"            # a rank would cut an int4 group
        if layout == "mixed":
            parts = {n: self.gather_model(t, sps[n])[0] for n, t in parts.items()}
            layout = None
        return parts, layout

    # -- products ----------------------------------------------------------------------

    def linear(self, x, p, sp, backend="fused", *, x_split=False, stash=None,
               adapters=None, name=None):
        """x @ kernel (+ bias) on this rank's blocks -> (y, y_split). A bias
        whose spec is split over ``model`` is already this rank's columns (a
        merged projection's, built from each rank's own q, k and v)."""
        k, layout = self.kernel(p["kernel"], sp["kernel"])
        bias = p.get("bias")
        bias_local = False
        if bias is not None:
            bias, bsp = self.gather_data(bias, sp["bias"])
            bias_local = bool(bsp) and bsp[-1] == "model"
            if bias_local and layout != "out":
                bias, bias_local = self.gather_model(bias, bsp)[0], False
        mc = self.model
        if layout == "in":
            if not x_split:
                x = C.split_to(x, mc, -1)
            y = C.reduce_from(_product(x, k, backend, stash), mc)
            if bias is not None:
                y = y + bias
            if adapters is not None:
                y = y + adapters.delta(name, x, mode="row")
            return y, False
        if x_split:
            x = C.gather_from(x, mc, -1)
        mode = None
        if layout == "out":
            mode = "col"
            y = _product(C.copy_to(x, mc), k, backend, stash)
            if bias is not None and not bias_local:
                bias = C.split_to(bias, mc, -1)     # its gradient gathered whole
        else:
            y = _product(x, k, backend, stash)
        if bias is not None:
            y = y + bias
        if adapters is not None:
            y = y + adapters.delta(name, x, mode=mode)
        return y, layout == "out"

    def full(self, y, split):
        """An activation made whole over ``model``."""
        return C.gather_from(y, self.model, -1) if split else y

    def heads_local(self, num_heads: int, num_kv_heads: int) -> bool:
        """Attention on local heads: every kv head (and its group of q heads)
        whole on a rank."""
        return self.M == 1 or (num_kv_heads % self.M == 0 and num_heads % self.M == 0)


def _product(x, k, backend, stash):
    from ..ops.quant import linear as plain_linear

    p = {"kernel": k}
    return plain_linear(x, p, backend) if stash is None else stash.linear(x, p, backend)


def row_slice(obj, r0: int, r1: int):
    """A cache plan (``UpdatePlan`` / ``SpecPlans``) reduced to rows [r0, r1):
    per-row fields on their batch dim (dim 1 of the [S+1, B, ...] metadata
    stacks), the composed steps' plans likewise."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor) and v.dim() > 0:
            v = v[:, r0:r1] if f.name.startswith("meta_") else v[r0:r1]
        elif isinstance(v, tuple) and v and dataclasses.is_dataclass(v[0]):
            v = tuple(row_slice(s, r0, r1) for s in v)
        out[f.name] = v
    return type(obj)(**out)


_MERGED = {"qkv_proj": ("q_proj", "k_proj", "v_proj"), "gate_up_proj": ("gate_proj", "up_proj")}


def _split_cols(t, sizes):
    if isinstance(t, dict):
        parts = {n: torch.split(v, sizes, dim=-1) for n, v in t.items()}
        return [{n: parts[n][i] for n in t} for i in range(len(sizes))]
    return list(torch.split(t, sizes, dim=-1))


def unmerge_projections(llm: dict, q_dim: int, kv_dim: int) -> dict:
    """``merge_decoder_projections`` undone: qkv_proj -> q/k/v_proj and
    gate_up_proj -> gate/up_proj (views of the merged tensors)."""
    lyr = dict(llm["layers"])
    if "qkv_proj" in lyr:
        m = lyr.pop("qkv_proj")
        sizes = [q_dim, kv_dim, kv_dim]
        ks = _split_cols(m["kernel"], sizes)
        bs = _split_cols(m["bias"], sizes) if "bias" in m else [None] * 3
        for n, k, b in zip(_MERGED["qkv_proj"], ks, bs):
            lyr[n] = {"kernel": k, **({} if b is None else {"bias": b})}
    if "gate_up_proj" in lyr:
        m = lyr.pop("gate_up_proj")
        k = m["kernel"]
        N = (k["qvalue"] if isinstance(k, dict) and "qvalue" in k else
             k["q4value"] if isinstance(k, dict) else k).shape[-1]
        for n, kk in zip(_MERGED["gate_up_proj"], _split_cols(k, [N // 2, N // 2])):
            lyr[n] = {"kernel": kk}
    return {**llm, "layers": lyr}


def _merge_local(lyr: dict, lsp: dict) -> tuple[dict, dict]:
    """Each rank's own q, k, v (gate, up) blocks side by side, where all of
    them are split alike; the merged spec is q's (gate's), its bias marked as
    the rank's columns."""
    lyr, lsp = dict(lyr), dict(lsp)
    for merged, names in _MERGED.items():
        if not all(n in lyr for n in names):
            continue
        specs = [lsp[n]["kernel"] for n in names]
        if any(s != specs[0] for s in specs):
            continue                      # a split that cuts heads: leave them apart
        kernels = [lyr[n]["kernel"] for n in names]
        if isinstance(kernels[0], dict):
            k = {p: torch.cat([kk[p] for kk in kernels], dim=-1) for p in kernels[0]}
        else:
            k = torch.cat(kernels, dim=-1)
        entry, spec = {"kernel": k}, {"kernel": specs[0]}
        biases = [lyr[n].get("bias") for n in names]
        if all(b is not None for b in biases):
            main = specs[0] if not isinstance(specs[0], dict) else specs[0].get(
                "qvalue", specs[0].get("q4value"))
            split = main[-1] == "model"
            entry["bias"] = torch.cat(biases, dim=-1)
            spec["bias"] = (None,) * (entry["bias"].dim() - 1) + ("model" if split else None,)
        for n in names:
            lyr.pop(n)
            lsp.pop(n)
        lyr[merged], lsp[merged] = entry, spec
    return lyr, lsp


def place(params: dict, mesh, *, q_dim: int, kv_dim: int, merge: bool = False,
          prefix=()) -> tuple[dict, dict]:
    """A whole tree on every rank -> (this rank's blocks, their specs), by
    ``mesh.param_specs``. A merged decoder is placed by its q/k/v and gate/up
    rules (unmerged first: a contiguous slice of the merged columns would hand
    one rank all of k); ``merge`` then merges each rank's own blocks again.
    Replicated biases of a merged projection are sliced to the rank's columns
    here."""
    from .mesh import apply_named_sharding, local_block, param_specs

    tree = params
    if "llm" in tree and any(m in tree["llm"]["layers"] for m in _MERGED):
        tree = {**tree, "llm": unmerge_projections(tree["llm"], q_dim, kv_dim)}
    specs = param_specs(tree, mesh, prefix=prefix)
    local = apply_named_sharding(tree, mesh, specs)
    if merge and "llm" in local:
        lyr, lsp = local["llm"]["layers"], specs["llm"]["layers"]
        # biases are replicated: take this rank's columns before merging
        for n in ("q_proj", "k_proj", "v_proj"):
            if n in lyr and "bias" in lyr[n]:
                ksp = lsp[n]["kernel"]
                main = ksp if not isinstance(ksp, dict) else ksp.get("qvalue", ksp.get("q4value"))
                if main[-1] == "model":
                    bsp = (None,) * (lyr[n]["bias"].dim() - 1) + ("model",)
                    lyr[n] = {**lyr[n], "bias": local_block(lyr[n]["bias"], bsp, mesh)}
                    lsp[n] = {**lsp[n], "bias": bsp}
        lyr, lsp = _merge_local(lyr, lsp)
        local = {**local, "llm": {**local["llm"], "layers": lyr}}
        specs = {**specs, "llm": {**specs["llm"], "layers": lsp}}
    return local, specs
