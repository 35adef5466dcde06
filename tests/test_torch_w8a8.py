"""The W8A8 serving mode and the int8 vision tower of the port, on the CPU at
the tiny preset, against the JAX package: the SigLIP tower (and projector)
quantised, weight-only against JAX's ``auto`` backend (its dequantise-then-
einsum off the TPU) and with per-token int8 activations against JAX's
``w8a8`` backend (``qlinear_w8a8``, selected by ``quant._FORCE_BACKEND``,
set and reset by monkeypatch); and the sessions that ``--w8a8`` and
``--vision_int8`` build from parsed flags, with JAX's quirks: fused scoring
of 8 frames where the command has no batch of its own or a batch of 1, a
dense tower under ``--synthetic_weights``, ``--w8a8 --int4`` refused."""

import argparse
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu.config import aha_tiny
from aha_tpu.models import aha as jaha
from aha_tpu.ops import quant

from aha_tpu_torch import bridge
from aha_tpu_torch import config as tconfig
from aha_tpu_torch.models import aha as taha

KEYS = ("informative_score", "relevance_score", "uncertainty_score")
params_from_jax = functools.partial(bridge.params_from_jax, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _jax_backend(monkeypatch):
    """JAX's --w8a8 sets quant._FORCE_BACKEND for the process: every test
    starts from JAX's default and gives it back."""
    monkeypatch.setattr(quant, "_FORCE_BACKEND", None)


def port_cfg(cfg):
    d = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    d["llm"] = tconfig.QwenConfig(**dataclasses.asdict(cfg.llm))
    d["vision"] = tconfig.SiglipConfig(**dataclasses.asdict(cfg.vision))
    return tconfig.AhaConfig(**d)


@pytest.fixture(scope="module")
def model():
    params, cfg, _ = jaha.build_model_and_tokenizer(aha_tiny(), seed=0)
    return params, cfg


# tolerances, relative to the largest output magnitude. weight-only: the f32 sum of x times the int8 values,
# scaled once per column, against JAX's product with the dequantised weight (another
# order of rounding: 1e-5); int8 activations: the same integer sums on both sides, but
# JAX's quantiser multiplies by 1/127 where the port divides, so a rounding tie can fall
# the other way and move one int8 step of one activation (1e-4). The int8 tower is about
# 1e-2 of that magnitude away from the dense one.
TOWER = {"weight_only": ("fused", None, 1e-5), "a8": ("fused_a8", "w8a8", 1e-4)}


@pytest.mark.parametrize("mode", list(TOWER))
@pytest.mark.parametrize("hw", [(32, 32), (40, 48)])
def test_int8_tower_matches_jax(model, monkeypatch, mode, hw):
    """visual_embed over a tree with the tower and the projector quantised
    (``quantize_params(quantize_vision=True, keep_dense=("llm",))``, as
    ``--vision_int8`` alone builds it): the tower's q/k/v/out and fc1/fc2 and
    the projector on int8 weights, on the backend of the session, against
    JAX's at its backend, relative to the largest output; the int8 tower is
    not the dense one."""
    params, cfg = model
    backend, jax_backend, tol = TOWER[mode]
    qp = quant.quantize_params(params, quantize_vision=True, keep_dense=("llm",))
    assert "qvalue" in qp["vision"]["layers"]["fc1"]["kernel"]
    tp, tcfg = params_from_jax(jax.tree.map(np.asarray, qp)), port_cfg(cfg)
    frames = np.random.default_rng(0).integers(0, 256, (3, *hw, 3), dtype=np.uint8)
    out = taha.visual_embed(tp, tcfg, torch.from_numpy(frames), backend).numpy()
    monkeypatch.setattr(quant, "_FORCE_BACKEND", jax_backend)
    ref = np.asarray(jaha.visual_embed(qp, cfg, jnp.asarray(frames)))
    top = np.abs(ref).max()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= tol * top
    dense = taha.visual_embed(params_from_jax(jax.tree.map(np.asarray, params)), tcfg,
                              torch.from_numpy(frames)).numpy()
    assert np.abs(out - dense).max() > 1e-3 * top


def _args(add, *flags):
    p = argparse.ArgumentParser()
    add(p)
    return p.parse_args(["--test_dataset", "youcook2", "--input_dir", ".", "--output_fname",
                         "unused", "--model_preset", "tiny", *flags])


def _tower_quantised(params) -> bool:
    return isinstance(params["vision"]["layers"]["fc1"]["kernel"], dict)


# flags -> (fused width, tower quantised, the decoder's trunk int8)
SESSIONS = {
    "w8a8": (["--w8a8"], 8, True),
    "w8a8_synthetic": (["--w8a8", "--synthetic_weights"], 8, False),
    "w8a8_fused_1": (["--w8a8", "--fused_score_frames", "1"], 1, True),
    "vision_int8": (["--vision_int8"], 4, True),
    "vision_int8_int8": (["--vision_int8", "--int8"], 4, True),
    "vision_int8_synthetic": (["--vision_int8", "--synthetic_weights", "--int8"], 4, False),
}


@pytest.mark.parametrize("case", list(SESSIONS))
def test_serving_mode_session_matches_jax(case):
    """The session of ``infer --model_preset tiny`` with the flags: the fused
    width JAX's command line gives it (8 under --w8a8 at its default 4), the
    backend (``fused_a8`` for --w8a8: JAX's w8a8), whether the tower is int8
    (never under --synthetic_weights, as in JAX) and the decoder's weights
    alike on both sides; the scores of 6 frames against JAX's session at the
    1e-3 of the JSONL lines (2e-3 with int8 activations, whose quantiser ties can
    fall the other way)."""
    from aha_tpu.cli._session import _add_infer_flags as jflags
    from aha_tpu.cli._session import _build_session as jbuild

    from aha_tpu_torch.cli._session import _add_infer_flags, _build_session

    flags, fused, tower_int8 = SESSIONS[case]
    flags = [*flags, "--grounding_mode"]
    sess = _build_session(_args(_add_infer_flags, *flags, "--device", "cpu"))
    ref = jbuild(_args(jflags, *flags))
    w8a8 = "--w8a8" in flags
    assert (quant._FORCE_BACKEND == "w8a8") == w8a8
    assert sess.engine.backend == ("fused_a8" if w8a8 else "fused")
    assert sess.engine.fused_frames == ref.engine.fused_frames == fused
    assert _tower_quantised(sess.engine.params) == _tower_quantised(ref.engine.params) \
        == tower_int8
    assert (isinstance(sess.engine.params["llm"]["layers"]["o_proj"]["kernel"], dict)
            == isinstance(ref.engine.params["llm"]["layers"]["o_proj"]["kernel"], dict)
            == (case != "vision_int8"))
    frames = np.random.default_rng(3).integers(0, 256, (6, 32, 32, 3), dtype=np.uint8)
    got, want = (np.asarray([[r[k] for k in KEYS] for r in s.score_video(frames, query="what?")])
                 for s in (sess, ref))
    np.testing.assert_allclose(got, want, atol=2e-3 if w8a8 else 1e-3)


def test_w8a8_keeps_fused_4_at_a_batch(monkeypatch):
    """JAX widens fused scoring to 8 only where the command's ``batch`` is 1
    or absent: serve's --batch 8 keeps 4 (the batch rows already fill the
    products), --batch 1 takes 8, and a width set by hand stays."""
    from aha_tpu_torch.cli._session import _serving_mode

    for batch, fused, want in ((8, 4, 4), (1, 4, 8), (8, 2, 2), (None, 4, 8)):
        ns = argparse.Namespace(w8a8=True, int4=False, int8=False, vision_int8=False,
                                fused_score_frames=fused)
        if batch is not None:
            ns.batch = batch
        assert _serving_mode(ns) == "fused_a8"
        assert (ns.fused_score_frames, ns.int8, ns.vision_int8) == (want, True, True)


@pytest.mark.parametrize("synthetic", [False, True], ids=["random_init", "synthetic"])
def test_w8a8_with_int4_exits_as_jax(synthetic):
    """``--w8a8 --int4`` exits with JAX's message, on both sides."""
    from aha_tpu.cli._session import _add_infer_flags as jflags
    from aha_tpu.cli._session import _build_session as jbuild

    from aha_tpu_torch.cli._session import _add_infer_flags, _build_session

    flags = ["--w8a8", "--int4"] + (["--synthetic_weights"] if synthetic else [])
    with pytest.raises(SystemExit) as ref:
        jbuild(_args(jflags, *flags))
    with pytest.raises(SystemExit) as got:
        _build_session(_args(_add_infer_flags, *flags, "--device", "cpu"))
    assert str(got.value) == str(ref.value) and "mutually exclusive" in str(got.value)
