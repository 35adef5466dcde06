"""The port's weights (aha_tpu_torch/models/loader.py, ops/quant.py's
quantisers, golden.py) against the JAX package on the CPU: the leaf list
against jax.eval_shape at the tiny and the 7B preset, the synthetic and the
seeded-init trees (integer leaves bit-equal, float leaves within 3 f32 ulps,
bf16 leaves within one step), quantize_params and merge_decoder_projections
bit-equal, the safetensors reader against the safetensors package, load_params
and export against JAX's on a synthetic Hugging Face checkpoint, the command
line's checkpoint session against JAX's, and the golden fixtures' replay."""

import argparse
import dataclasses
import functools
import json
import pathlib
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import config as jconfig
from aha_tpu.models import aha as jaha
from aha_tpu.models import loader as jloader
from aha_tpu.ops import quant as jquant

from aha_tpu_torch import bridge, golden
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.models import loader
from aha_tpu_torch.ops import quant

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")
KEYS = ("informative_score", "relevance_score", "uncertainty_score")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def persist_small_programs():
    """JAX's materialize_random_params compiles a program a leaf, 0.1-0.4 s
    each, under the persistent cache's 1 s floor (tests/conftest.py); the trees
    of other modes and dtypes share most of them."""
    old = jax.config.jax_persistent_cache_min_compile_time_secs
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    yield
    jax.config.update("jax_persistent_cache_min_compile_time_secs", old)


def port_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


def bridged(tree):
    return params_from_jax(jax.tree.map(np.asarray, tree))


def assert_trees(got, ref, float_ulps: float = 0):
    """Same paths, shapes and dtypes; integer leaves bit-equal; float leaves
    within ``float_ulps`` steps of their dtype (0: bit-equal)."""
    fg, fr = loader._flatten(got), loader._flatten(ref)
    assert [p for p, _ in fg] == [p for p, _ in fr]
    for (path, a), (_, b) in zip(fg, fr):
        assert (a.dtype, a.shape) == (b.dtype, b.shape), path
        if not a.is_floating_point() or float_ulps == 0:
            assert torch.equal(a, b), path
            continue
        step = torch.from_numpy(np.spacing(np.abs(b.float().numpy())))
        if b.dtype == torch.bfloat16:
            step = step * 2**16
        assert ((a.float() - b.float()).abs() <= float_ulps * step).all(), path


def jax_leaves(cfg, mode):
    s = jax.eval_shape(lambda: jaha.init_aha_params(cfg, jax.random.PRNGKey(0)))
    if mode is not None:
        s = jax.eval_shape(lambda p: jquant.quantize_params(p, bits=4 if mode == "int4" else 8), s)
    out = []
    jax.tree_util.tree_map_with_path(
        lambda p, leaf: out.append((tuple(str(k.key) for k in p), tuple(leaf.shape),
                                    str(leaf.dtype))), s)
    return out


@pytest.mark.parametrize("preset", ["tiny", "7b", "tiny-cls", "tiny-clip"])
@pytest.mark.parametrize("mode", [None, "int8", "int4"])
def test_leaf_specs_match_eval_shape(preset, mode):
    """Path, shape and dtype of every leaf, in JAX's drawing order: one leaf
    out of place would shift every later key. Both towers: SigLIP with and
    without its probe head, and CLIP."""
    cfg = {"tiny": jconfig.aha_tiny(), "7b": jconfig.aha_7b(),
           "tiny-cls": jconfig.aha_tiny().replace(frame_token_cls=True),
           "tiny-clip": jconfig.aha_tiny().replace(vision=jconfig.clip_tiny())}[preset]
    got = [(p, s, str(d).removeprefix("torch.")) for p, s, d in
           loader.leaf_specs(port_cfg(cfg), mode)]
    assert got == jax_leaves(cfg, mode)


@pytest.mark.parametrize("mode, dtype", [(None, "float32"), ("int8", "float32"),
                                         ("int4", "float32"), ("int8", "bfloat16"),
                                         (None, "bfloat16")])
def test_materialize_random_params_matches_jax(mode, dtype, persist_small_programs):
    """JAX's synthetic tree at tiny, merged as its engine serves a quantised
    one: integer leaves and constant scales bit-equal, normal leaves within 3
    f32 ulps (bf16: one step)."""
    cfg = jconfig.aha_tiny().replace(dtype=dtype)
    ref = jloader.materialize_random_params(cfg, mode)
    if mode is not None:
        ref = {**ref, "llm": jquant.merge_decoder_projections(ref["llm"])}
    got = loader.materialize_random_params(port_cfg(cfg), mode, device="cpu", slab=5000)
    assert_trees(got, bridged(ref), float_ulps=3 if dtype == "float32" else 1)


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
@pytest.mark.parametrize("cls", [False, True])
def test_init_aha_params_matches_jax(dtype, cls):
    cfg = jconfig.aha_tiny().replace(frame_token_cls=cls)
    ref = jaha.init_aha_params(cfg, jax.random.PRNGKey(3), dtype and jnp.bfloat16)
    got = loader.init_aha_params(port_cfg(cfg), seed=3, dtype=dtype, device="cpu")
    assert_trees(got, bridged(ref), float_ulps=3 if dtype is None else 1)


def test_init_aha_params_in_slabs():
    """Drawn in slabs of a few thousand values (a 7B leaf's counters would not
    fit the card whole), every leaf equals the whole draw bit for bit."""
    cfg = port_cfg(jconfig.aha_tiny())
    whole = loader.init_aha_params(cfg, seed=3, device="cpu", slab=1 << 40)
    assert_trees(loader.init_aha_params(cfg, seed=3, device="cpu", slab=3001), whole,
                 float_ulps=0)


def test_materialize_refuses():
    cfg = tconfig.aha_tiny()
    with pytest.raises(ValueError, match="mode"):
        loader.materialize_random_params(cfg, "int2", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            loader.materialize_random_params(cfg, "int8")


# -- quantisers ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def dense_tiny():
    cfg = jconfig.aha_tiny(vocab_size=300)
    params = jaha.init_aha_params(cfg, jax.random.PRNGKey(5))
    return params, bridged(params)


@pytest.mark.parametrize("kw", [dict(), dict(bits=4), dict(bits=4, keep_dense=("projector",
                                                                            "lm_head")),
                                dict(quantize_embed=False), dict(bits=8, group=64),
                                dict(quantize_vision=True)],
                         ids=["int8", "int4", "int4-qlora", "no-embed", "int8-g64", "vision"])
def test_quantize_params_and_merge_bit_equal(dense_tiny, kw):
    """quantize_params on a bridged dense tree, then merge_decoder_projections,
    equal bit for bit to JAX's (the vision tower's patch kernel is skipped, so
    its layout does not matter)."""
    jp, tp = dense_tiny
    ref = jquant.quantize_params(jp, **kw)
    got = quant.quantize_params(tp, **kw)
    assert_trees(got, bridged(ref))
    assert_trees({**got, "llm": quant.merge_decoder_projections(got["llm"])},
                 bridged({**ref, "llm": jquant.merge_decoder_projections(ref["llm"])}))


def test_merge_dense_bit_equal(dense_tiny):
    jp, tp = dense_tiny
    assert_trees(quant.merge_decoder_projections(tp["llm"]),
                 bridged(jquant.merge_decoder_projections(jp["llm"])))


@pytest.mark.parametrize("shape, axis, dtype", [((3, 256, 40), 1, np.float32),
                                                ((64, 33), 0, np.float32),
                                                ((50, 64), 1, np.float32),
                                                ((3, 256, 40), 1, "bfloat16"),
                                                ((7, 9), 0, np.float32)])
def test_quantize_array_bit_equal(shape, axis, dtype):
    """Including rows of zeros (the 1e-12 floor) and values at half steps."""
    w = (np.random.default_rng(1).standard_normal(shape) * 0.02).astype(np.float32)
    w[..., :1] = 0.0
    w.reshape(-1)[1::17] = 0.5 * np.round(w.reshape(-1)[1::17] * 254) / 127 * np.abs(w).max()
    wj = jnp.asarray(w).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(w)
    ref = bridged(jquant.quantize_array(wj, axis))
    assert_trees(quant.quantize_array(bridge.tensor_from_numpy(np.asarray(wj)), axis), ref)
    if len(shape) >= 2 and axis % len(shape) == len(shape) - 2 and shape[-2] % 2 == 0:
        g = 128 if shape[-2] % 128 == 0 else shape[-2]
        ref4 = bridged(jquant.quantize_array_int4(wj, axis, g))
        assert_trees(quant.quantize_array_int4(bridge.tensor_from_numpy(np.asarray(wj)), axis, g),
                     ref4)


# -- checkpoints ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """scripts/make_synthetic_hf_checkpoint.py's reduced llava-onevision
    artifact: two bf16 .safetensors shards in the reference's key layout,
    config.json (vocab 2048) and a byte-level BPE tokenizer."""
    import make_synthetic_hf_checkpoint

    ov, _ = make_synthetic_hf_checkpoint.generate(str(tmp_path_factory.mktemp("ckpt")))
    return pathlib.Path(ov)


def test_read_safetensors_matches_the_library(checkpoint):
    from safetensors import safe_open

    got = loader.read_state_dict(str(checkpoint))
    n = 0
    for f in sorted(checkpoint.glob("*.safetensors")):
        with safe_open(str(f), framework="pt") as h:
            for key in h.keys():
                ref = h.get_tensor(key)
                assert got[key].dtype == ref.dtype == torch.bfloat16
                assert torch.equal(got[key], ref), key
                n += 1
    assert n == len(got) > 50


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_load_params_matches_jax(checkpoint, dtype):
    """load_params of the port against bridge.params_from_jax of JAX's, leaf by
    leaf and bit for bit (the vision tower under the double-wrapped prefix)."""
    jcfg = jconfig.aha_tiny(vocab_size=2048)
    ref = jloader.load_params(str(checkpoint), jcfg, jnp.dtype(dtype))
    got = loader.load_params(str(checkpoint), port_cfg(jcfg), getattr(torch, dtype),
                             device="cpu")
    assert_trees(got, bridged(ref))


def test_export_matches_jax_and_round_trips(tmp_path):
    """export_hf_state_dict against JAX's (kernels back to [out, in], the patch
    kernel in torch's OIHW), written in shards by the port's writer (read back
    by the safetensors package too), read and converted back: the same tree
    bit for bit."""
    from safetensors.torch import load_file

    jcfg = jconfig.aha_tiny(vocab_size=300).replace(frame_token_cls=True)
    jp = jaha.init_aha_params(jcfg, jax.random.PRNGKey(4), jnp.bfloat16)
    tp, cfg = bridged(jp), port_cfg(jcfg)
    sd = loader.export_hf_state_dict(tp, cfg)
    ref = jloader.export_hf_state_dict(jp, jcfg)
    assert list(sd) == list(ref)
    for k in sd:
        assert torch.equal(sd[k], bridge.tensor_from_numpy(ref[k])), k
    paths = loader.save_sharded(sd, str(tmp_path / "ckpt"), max_shard_bytes=60_000)
    assert len(paths) > 2
    index = json.loads((tmp_path / "ckpt" / "model.safetensors.index.json").read_text())
    assert set(index["weight_map"]) == set(sd)
    back = loader.read_state_dict(str(tmp_path / "ckpt"))
    for p in paths:
        for k, v in load_file(p).items():
            assert torch.equal(v, back[k]) and torch.equal(v, sd[k]), k
    got = loader.load_params(str(tmp_path / "ckpt"), cfg, torch.bfloat16, device="cpu")
    assert_trees(got, tp)


def test_torch_shards_and_converted_files(tmp_path):
    """.bin shards (torch.load, weights only) load as .safetensors do; a
    converted tree round-trips through save_converted / load_converted."""
    cfg = tconfig.aha_tiny(vocab_size=300)
    tp = loader.init_aha_params(cfg, seed=2, device="cpu")
    sd = {k: v.contiguous() for k, v in loader.export_hf_state_dict(tp, cfg).items()}
    (tmp_path / "bin").mkdir()
    keys = list(sd)
    torch.save({k: sd[k] for k in keys[:40]}, tmp_path / "bin" / "pytorch_model-1.bin")
    torch.save({k: sd[k] for k in keys[40:]}, tmp_path / "bin" / "pytorch_model-2.bin")
    assert_trees(loader.load_params(str(tmp_path / "bin"), cfg, torch.float32, device="cpu"), tp)
    loader.save_converted(tp, str(tmp_path / "tree.pt"))
    assert_trees(loader.load_converted(str(tmp_path / "tree.pt"), device="cpu"), tp)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="shards"):
        loader.read_state_dict(str(tmp_path / "empty"))


# -- the command line on a checkpoint -----------------------------------------------------


def _infer_args(add_flags, *extra):
    p = argparse.ArgumentParser()
    add_flags(p)
    return p.parse_args(["--test_dataset", "youcook2", "--input_dir", ".",
                         "--output_fname", "unused", *extra])


@pytest.mark.parametrize("quantised", [[], ["--int8"], ["--int4"]], ids=["dense", "int8", "int4"])
def test_cli_checkpoint_session_matches_jax(checkpoint, quantised):
    """The session of `infer --llm_pretrained ov --tokenizer_pretrained ov
    --model_preset tiny` (vocab_size adopted from config.json, the checkpoint's
    BPE tokenizer, then quantised and merged per the flags) scores frames as the
    JAX command's session does (atol 1e-3, the drivers' tolerance)."""
    from aha_tpu.cli._session import _add_infer_flags as jflags
    from aha_tpu.cli._session import _build_session as jbuild

    from aha_tpu_torch.cli._session import _add_infer_flags, _build_session

    flags = ["--llm_pretrained", str(checkpoint), "--tokenizer_pretrained", str(checkpoint),
             "--model_preset", "tiny", "--grounding_mode", *quantised]
    ref = jbuild(_infer_args(jflags, *flags))
    sess = _build_session(_infer_args(_add_infer_flags, *flags, "--device", "cpu"))
    assert sess.engine.cfg.llm.vocab_size == 2048
    if quantised:
        assert "qkv_proj" in sess.engine.params["llm"]["layers"]
    frames = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    got = sess.score_video(frames, query="what is this?")
    want = ref.score_video(frames, query="what is this?")
    np.testing.assert_allclose([[r[k] for k in KEYS] for r in got],
                               [[r[k] for k in KEYS] for r in want], atol=1e-3)


# -- the golden fixtures ---------------------------------------------------------------


def test_golden_tiny_replay():
    """python -m aha_tpu_torch.golden --fixture tiny: JAX's seed-0 init made by
    the port alone replays golden_tiny_cpu.npz (atol 1e-4, texts equal)."""
    report = golden.replay("tiny", "cpu")
    assert report["ok"], report
    assert report["gen_texts_seq"] == [None] * 8 and report["texts_seq_equal_spec"]


def test_chip_fixture_inputs_reproduce():
    """golden_7b_int8_chip.npz's frames (pinned by hash) and rendered ids at the
    7B preset's tokenizer come out of the port's recipe on the CPU."""
    ref = np.load(golden.FIXTURES["chip7b"], allow_pickle=False)
    assert golden.frames_sha256(golden.fixed_frames()) == str(ref["frames_sha256"])
    from aha_tpu_torch.tokenization import build_stream_tokenizer

    cfg = tconfig.aha_7b()
    tok = build_stream_tokenizer(None, frame_num_tokens=cfg.frame_num_tokens,
                                 vocab_size=cfg.llm.vocab_size)
    np.testing.assert_array_equal(golden.rendered_ids(tok), ref["ids"])
    # the fixture's texts are the char tokenizer's: encode inverts decode
    for text in ref["gen_texts_seq"]:
        assert tok.decode(tok.backend.encode(str(text))) == text


def test_first_divergences_reads_ties():
    """A divergence's gap to the port's top logit in bf16 steps."""
    tok = golden.build("tiny", "cpu")[2]
    logits = [[torch.tensor([0.0, 1.0, 0.99609375, -3.0])] * 3]
    d = golden.first_divergences(["\x01\x01\x01"], ["\x01\x02\x01"], tok, logits)[0]
    assert (d["token"], d["port"], d["fixture"]) == (1, 1, 2)
    assert d["top2"] == [(1, 1.0), (2, 0.99609375)]
    assert d["gap_bf16_steps"] == pytest.approx(0.5)
    assert golden.texts_ok("chip7b", [d]) and not golden.texts_ok("tiny", [d])
    assert golden.first_divergences(["ab"], ["ab"], tok) == [None]


def test_weights_run_without_jax(tmp_path):
    """In a fresh interpreter where importing jax or aha_tpu raises: JAX's dense
    synthetic tiny tree exported, written and read back by the port's own
    safetensors code (no safetensors package imported), and `infer
    --llm_pretrained DIR --int8` on it. (golden.py's replay imports only modules
    that test_port_runs_without_jax imports with jax blocked.)"""
    code = textwrap.dedent(f"""
        import importlib.abc, json, os, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in ("jax", "jaxlib", "aha_tpu", "safetensors"):
                    raise ImportError("blocked for this test: " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        import torch
        torch.set_num_threads(1)
        import cv2
        from aha_tpu_torch.cli import main
        from aha_tpu_torch.config import aha_tiny
        from aha_tpu_torch.models import loader
        d = {str(tmp_path)!r}
        cfg = aha_tiny()
        dense = loader.materialize_random_params(cfg, None, device="cpu")
        loader.save_sharded(loader.export_hf_state_dict(dense, cfg), os.path.join(d, "ckpt"),
                            max_shard_bytes=100_000)
        back = loader.load_params(os.path.join(d, "ckpt"), cfg, device="cpu")
        assert all(torch.equal(a, b) for (_, a), (_, b) in zip(loader._flatten(back),
                                                                loader._flatten(dense)))
        out = cv2.VideoWriter(os.path.join(d, "v.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 4.0,
                              (32, 32))
        for i in range(8):
            out.write(np.full((32, 32, 3), 20 * i, np.uint8))
        out.release()
        with open(os.path.join(d, "qa.json"), "w") as f:
            json.dump([{{"question_id": "q", "video": "v.mp4", "conversation": [
                {{"role": "user", "content": "hi", "time": 0}}]}}], f)
        assert main(["infer", "--model_preset", "tiny", "--device", "cpu",
                     "--llm_pretrained", os.path.join(d, "ckpt"), "--int8",
                     "--test_dataset", "generic", "--input_dir", d,
                     "--test_fname", os.path.join(d, "qa.json"),
                     "--output_fname", os.path.join(d, "out.jsonl"), "--grounding_mode"]) == 0
        with open(os.path.join(d, "out.jsonl")) as f:
            assert len(json.loads(f.readline())["debug_data"]) == 4
        bad = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "aha_tpu", "safetensors")]
        assert not bad, bad
        print("ok")
    """)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr[-2000:]
