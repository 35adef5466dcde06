"""The port's sharding rules (aha_tpu_torch/parallel/mesh.py) and its
multi-process helpers (aha_tpu_torch/utils/dist.py) against the JAX
package's, with no process group: ``param_specs`` leaf for leaf on the tiny
dense, int8, int4 and LoRA trees at meshes 1x1, 2x1, 1x2, 2x2, 4x2 and
2x1x2 (JAX's on the 8-device CPU mesh), at the 7B with every rank's local
shape (JAX's ``jax.eval_shape`` tree and its NamedShardings' shard shapes
against the port's ``meta`` tree), ``cache_specs``,
``multihost_env_detected`` and ``shard_iterable``."""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding

from aha_tpu.config import LoraConfig as JLoraConfig
from aha_tpu.config import aha_7b as jaha_7b
from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import kv_cache as jkv
from aha_tpu.ops import quant as jquant
from aha_tpu.parallel import mesh as jmesh
from aha_tpu.train import lora as jlora
from aha_tpu.utils import dist as jdist

from aha_tpu_torch import bridge
from aha_tpu_torch.config import aha_7b
from aha_tpu_torch.models.loader import leaf_specs
from aha_tpu_torch.ops import kv_cache
from aha_tpu_torch.parallel import mesh
from aha_tpu_torch.utils import dist

MESHES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (2, 2, 1), (4, 2, 1), (2, 1, 2)]


def jax_mesh(d, m, p):
    return jmesh.make_mesh(d, m, p, devices=jax.devices()[:d * m * p])


def port_mesh(d, m, p):
    return mesh.make_mesh(d, m, p, devices=d * m * p)


@pytest.fixture(scope="module")
def trees():
    params, cfg, _ = jaha.build_model_and_tokenizer(aha_tiny(vocab_size=128), seed=1)
    lora = jlora.init_lora(cfg.llm, JLoraConfig(), jax.random.PRNGKey(0))
    out = {}
    for name, p in (("dense", params),
                    ("int8", jquant.quantize_params(params, bits=8)),
                    ("int4", jquant.quantize_params(params, bits=4)),
                    ("int8_merged", {**jquant.quantize_params(params, bits=8),
                                     "llm": jquant.merge_decoder_projections(
                                         jquant.quantize_params(params, bits=8)["llm"])})):
        out[name] = jax.tree.map(np.asarray, p)
    out["lora"] = {"model": out["dense"], "lora": jax.tree.map(np.asarray, lora)}
    return out


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, tree


def _jax_specs(tree, m):
    specs = jmesh.param_specs(tree, m)
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(s)
            for path, s in jax.tree_util.tree_flatten_with_path(
                specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]}


@pytest.mark.parametrize("shape", MESHES, ids=["x".join(map(str, s)) for s in MESHES])
@pytest.mark.parametrize("kind", ["dense", "int8", "int4", "int8_merged", "lora"])
def test_param_specs_match_jax(trees, kind, shape):
    tree = trees[kind]
    want = _jax_specs(tree, jax_mesh(*shape))
    ported = bridge.params_from_jax(tree, device="cpu") if kind != "lora" else {
        k: bridge.params_from_jax(v, device="cpu") for k, v in tree.items()}
    got = dict(_flat(mesh.param_specs(ported, port_mesh(*shape))))
    assert set(got) == set(want)
    for path in want:
        assert tuple(got[path]) == want[path], path
    if shape == (2, 2, 1):
        sharded = [p for p, s in want.items() if any(s)]
        assert len(sharded) >= 10


@pytest.mark.parametrize("shape", [(2, 2, 1), (1, 4, 1), (4, 2, 1), (2, 1, 2)],
                         ids=["2x2", "1x4", "4x2", "2x1x2"])
def test_7b_specs_and_local_shapes_match_jax(shape):
    """JAX's 7B tree from ``jax.eval_shape`` and the port's on the meta device
    (nothing materialised): the same specs, and every rank's shard shape of
    each leaf equal to the port's ``local_shape`` (the patch kernel crosses
    in JAX's layout here, as ``leaf_specs`` gives it)."""
    import jax.numpy as jnp

    cfg7 = jaha_7b().replace(dtype="bfloat16")
    shapes = jax.eval_shape(lambda: jaha.init_aha_params(cfg7, jax.random.PRNGKey(0),
                                                         jnp.bfloat16))
    jm = jax_mesh(*shape)
    jspecs = jmesh.param_specs(shapes, jm)
    want = {}
    for (path, s), (_, sp) in zip(
            jax.tree_util.tree_flatten_with_path(shapes)[0],
            jax.tree_util.tree_flatten_with_path(
                jspecs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]):
        key = tuple(str(getattr(k, "key", k)) for k in path)
        want[key] = (tuple(sp), tuple(NamedSharding(jm, sp).shard_shape(s.shape)))
    tree: dict = {}
    for path, shp, dtype in leaf_specs(aha_7b()):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.empty(shp, dtype=dtype, device="meta")
    pm = port_mesh(*shape)
    got = {p: (tuple(s), mesh.local_shape(tuple(_get(tree, p).shape), s, pm))
           for p, s in _flat(mesh.param_specs(tree, pm))}
    assert got == want


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("dtype", ["bf16", "int8"])
def test_cache_specs_match_jax(dtype):
    pol = dict(kind="sink", window=16, num_sink=2)
    kw = dict(num_layers=2, batch=4, num_kv_heads=4, head_dim=8)
    import jax.numpy as jnp

    jc = jkv.init_cache(jkv.CachePolicy(**pol), **kw,
                        dtype=jnp.int8 if dtype == "int8" else jnp.bfloat16)
    tc = kv_cache.init_cache(kv_cache.CachePolicy(**pol), device="cpu",
                             dtype=torch.int8 if dtype == "int8" else torch.bfloat16, **kw)
    for shape in MESHES:
        js = jmesh.cache_specs(jc, jax_mesh(*shape))
        ts = mesh.cache_specs(tc, port_mesh(*shape))
        for f in dataclasses.fields(js):
            j = getattr(js, f.name)
            assert (None if j is None else tuple(j)) == (
                None if ts[f.name] is None else tuple(ts[f.name])), (shape, f.name)


def test_make_mesh_coordinates_and_errors():
    """JAX's rank order: np.arange(world).reshape(data, model[, pipe]); a world
    of another size names the ranks the mesh needs."""
    m = mesh.Mesh(2, 2, 2, rank=5, groups=False)
    assert m.axis_names == ("data", "model", "pipe")
    assert m.coords == {"data": 1, "model": 0, "pipe": 1}
    assert mesh.make_mesh(-1, 2, devices=8).shape == {"data": 4, "model": 2}
    with pytest.raises(mesh.RanksError, match="mesh 1x2 needs 2 ranks; start it with "
                                              "torchrun --nproc_per_node 2"):
        mesh.make_mesh(1, 2)
    assert mesh.local_rows(8, mesh.Mesh(4, 1, rank=2, groups=False)) == (4, 6)
    assert mesh.local_rows(6, mesh.Mesh(4, 1, rank=2, groups=False)) is None


ENV_CASES = [
    ({}, False),
    ({"AHA_COORDINATOR_ADDRESS": "h:1234"}, True),
    ({"COORDINATOR_ADDRESS": "h:1234"}, True),
    ({"WORLD_SIZE": "2", "MASTER_ADDR": "localhost"}, True),
    ({"WORLD_SIZE": "1", "MASTER_ADDR": "localhost"}, False),
    ({"WORLD_SIZE": "4"}, False),
    ({"SLURM_NTASKS": "2"}, True),
    ({"SLURM_NTASKS": "1"}, False),
    ({"OMPI_COMM_WORLD_SIZE": "3"}, True),
    ({"SLURM_NTASKS": "x"}, False),
]


@pytest.mark.parametrize("env,want", ENV_CASES)
def test_multihost_env_detected(monkeypatch, env, want):
    """torchrun's, SLURM's and Open MPI's worlds, and an explicit coordinator;
    on the cases both read alike, JAX's answer too."""
    for k in ("AHA_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS", "WORLD_SIZE", "MASTER_ADDR",
              "SLURM_NTASKS", "OMPI_COMM_WORLD_SIZE", "JAX_COORDINATOR_ADDRESS",
              "TPU_WORKER_HOSTNAMES", "MEGASCALE_COORDINATOR_ADDRESS"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist.multihost_env_detected() is want
    if not set(env) & {"AHA_COORDINATOR_ADDRESS", "WORLD_SIZE", "MASTER_ADDR"}:
        assert jdist.multihost_env_detected() is want
    if not want:
        assert dist.maybe_init_distributed("cpu") is None


@pytest.mark.parametrize("n,shards", [(10, 3), (7, 1), (4, 4), (0, 2)])
def test_shard_iterable_matches_jax(n, shards):
    for r in range(shards):
        got = list(dist.shard_iterable(range(n), shards, r))
        assert got == list(jdist.shard_iterable(range(n), shards, r))
    assert sorted(x for r in range(shards) for x in dist.shard_iterable(range(n), shards, r)) \
        == list(range(n))
