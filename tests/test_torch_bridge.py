"""The param bridge: a JAX param tree of the tiny preset crosses to torch with
every leaf's values, layout and dtype intact (the patch-embedding conv
kernel moves HWIO -> OIHW): dense f32 and bf16, int8 with split and merged
projections, and packed int4 (whose carried nibbles and bf16 group scales
dequantize on the port's side to what JAX dequantizes them to)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import aha_tiny
from aha_tpu.models import aha
from aha_tpu.ops import quant

from aha_tpu_torch import bridge
from aha_tpu_torch.bridge import PATCH_KERNEL
from aha_tpu_torch.ops.quant import dequantize_int4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Tiny shapes gain nothing from intra-op threads, and the suite runs
    six workers on the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the bridge puts a tree on the card unless told otherwise; these tests run on the host
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16, "int8": torch.int8,
       "uint8": torch.uint8}


@pytest.fixture(scope="module")
def base():
    params, _, _ = aha.build_model_and_tokenizer(aha_tiny(), seed=0)
    return params


def _variant(params, name):
    if name == "dense_f32":
        return params
    if name == "dense_bf16":
        return jax.tree.map(lambda x: x.astype(jnp.bfloat16), params)
    q = quant.quantize_params(params, bits=4 if name == "int4_merged" else 8)
    if name.endswith("merged"):
        q = {**q, "llm": quant.merge_decoder_projections(q["llm"])}
    return q


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


@pytest.mark.parametrize("name", ["dense_f32", "dense_bf16", "int8", "int8_merged",
                                  "int4_merged"])
def test_params_round_trip(base, name):
    jtree = jax.tree.map(np.asarray, _variant(base, name))
    ttree = params_from_jax(jtree)
    jl, tl = dict(_leaves(jtree)), dict(_leaves(ttree))
    assert jl.keys() == tl.keys()
    if name.endswith("merged"):
        assert "qkv_proj" in ttree["llm"]["layers"] and "q_proj" not in ttree["llm"]["layers"]
    for path, arr in jl.items():
        t = tl[path]
        assert t.dtype == _DT[arr.dtype.name], path
        if path == PATCH_KERNEL:
            t = t.permute(2, 3, 1, 0)                 # OIHW back to HWIO
        assert tuple(t.shape) == arr.shape, path
        if arr.dtype.name == "bfloat16":
            np.testing.assert_array_equal(t.contiguous().view(torch.int16).numpy(),
                                          arr.view(np.int16), err_msg=str(path))
        else:
            np.testing.assert_array_equal(t.numpy(), arr, err_msg=str(path))


def _q4_kernels(tree, path=()):
    if isinstance(tree, dict):
        if "q4value" in tree:
            yield path, tree
        else:
            for k, v in tree.items():
                yield from _q4_kernels(v, path + (k,))


def test_int4_tree_dequantizes_as_in_jax(base):
    """quantize_params(bits=4) + merge_decoder_projections crosses exactly
    (covered leaf by leaf above), and every packed kernel of the carried
    tree (stacked decoder projections, projector, lm_head) dequantizes to
    JAX's values exactly: same nibble order, offset and group size."""
    jq = _variant(base, "int4_merged")
    ttree = params_from_jax(jax.tree.map(np.asarray, jq))
    jk, tk = dict(_q4_kernels(jq)), dict(_q4_kernels(ttree))
    assert jk.keys() == tk.keys() and len(tk) >= 7
    assert ("llm", "layers", "qkv_proj", "kernel") in tk and ("llm", "lm_head", "kernel") in tk
    for path, q in jk.items():
        np.testing.assert_array_equal(dequantize_int4(tk[path], torch.float32).numpy(),
                                      np.asarray(quant.dequantize_int4(q, jnp.float32)),
                                      err_msg=str(path))
