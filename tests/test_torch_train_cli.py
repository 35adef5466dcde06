"""``python -m aha_tpu_torch.cli train`` against the JAX package's
``cmd_train`` with the same flags, at ``--model_preset tiny`` on clips
written with cv2 and a grounding + DVC mixture: the int8 trunk under remat
'dots', the int4 trunk under 'dots_no_batch' continued from a peft adapter
(``--lora_pretrained``), and the dense trunk with gradient accumulation,
interrupted and resumed from ``latest_checkpoint``. Every loss part of every
logged micro-step within 1e-4 of JAX's, over enough updates that the later
steps follow updates at a non-zero rate (the schedule's first update has
rate 0); every trained leaf of the last checkpoint within 5e-4 of its
largest magnitude of JAX's final state; the checkpoints and the export
written; a resumed run equal to an uninterrupted one; every refused flag
exits 2 with its ROADMAP item.

Both packages train from JAX's seed-0 weights and JAX's adapter draw
(the port reproduces both bit for bit). Held equal for the comparison:
adapter-input dropout off (the two packages draw their masks from different
generators, equal in distribution only), one decode worker (two threads
would race on a dataset's instruction draws, in JAX as in the port), JAX on
both on their cv2 decoders, and the global ``random``
seeded before each run (the grounding templates are drawn from it, in both).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import os
import random

import jax
import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu.cli.train import cmd_train as jax_cmd_train
from aha_tpu.train import trainer as jtrainer

from aha_tpu_torch.cli import main
from aha_tpu_torch.cli.train import cmd_train
from aha_tpu_torch.config import aha_tiny
from aha_tpu_torch.models import loader
from aha_tpu_torch.train import trainer as ttrainer
from aha_tpu_torch.train.lora import LORA_PROJS, proj_dims

cv2 = pytest.importorskip("cv2")

PARTS = ("total_loss", "lm_loss", "video_loss", "info_loss", "ref_loss", "tv_loss",
         "uncertainty_loss")


@pytest.fixture(autouse=True, scope="module")
def _compile_in_memory():
    """JAX's ``cmd_train`` builds a new jitted step a call, so a second call of
    one program finds it in the persistent compilation cache that
    tests/conftest.py turns on, and running that executable aborted the
    process now and then (XLA:CPU, jax 0.9). This module compiles in memory.
    jax decides once a process whether it uses the cache, at its first
    compile, and reads the flag no more after that: a worker that compiled
    for another module first (``--dist load`` hands this module's tests to
    such workers) kept reading executables from the cache, and aborted. So the
    decision is reset with the flag, here and after the module."""
    from jax._src import compilation_cache

    before = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    compilation_cache.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", before)
    compilation_cache.reset_cache()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def held_equal(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too
    for mod in (jtrainer, ttrainer):
        make = mod.make_train_step

        def no_dropout(cfg, tc, *a, _make=make, **k):
            return _make(cfg, dataclasses.replace(
                tc, lora=dataclasses.replace(tc.lora, dropout=0.0)), *a, **k)

        monkeypatch.setattr(mod, "make_train_step", no_dropout)


@pytest.fixture()
def jax_states(monkeypatch):
    """The states JAX's ``train`` returns, in call order (its command returns
    nothing)."""
    states = []
    train = jtrainer.train

    def keep(*a, **k):
        states.append(train(*a, **k))
        return states[-1]

    monkeypatch.setattr(jtrainer, "train", keep)
    return states


def write_clip(path, n_frames, fps=4.0, size=(48, 32), seed=0):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(seed)
    for _ in range(n_frames):
        out.write(rng.integers(0, 255, (size[1], size[0], 3)).astype(np.uint8))
    out.release()


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Clips of unequal length (rows pad), a grounding and a DVC file and the
    mixture over them at 1 fps, 4 frames at most (one length bucket)."""
    d = tmp_path_factory.mktemp("train_data")
    vids = d / "videos"
    vids.mkdir()
    for i, n in enumerate((16, 12)):
        write_clip(vids / f"v{i}.mp4", n, seed=i)
    (d / "g.json").write_text(json.dumps([
        {"video_uid": f"v{i}.mp4", "query": f"thing {i}", "timestamps": [[1.0, 2.0]]}
        for i in range(2)]))
    (d / "d.json").write_text(json.dumps({
        "v0.mp4": {"a": [{"text": "a man walks", "time": 1.5, "timespan": [0.5, 1.5]},
                         {"text": "he sits", "time": 3.0, "timespan": [2.0, 3.0]}]},
        "v1.mp4": {"a": [{"text": "a dog runs", "time": 2.0, "timespan": [1.0, 2.0]}]}}))
    entry = dict(video_root=str(vids), metadata_path=str(d / "meta.json"), frame_fps=1.0,
                 max_num_frames=4)
    (d / "mix.json").write_text(json.dumps([
        dict(entry, dataset_cls="GroundingStreamDataset", anno_file=str(d / "g.json")),
        dict(entry, dataset_cls="DenseVideoCaptioningStreamDataset",
             anno_file=str(d / "d.json"))]))
    (d / "one.json").write_text(json.dumps([
        dict(entry, dataset_cls="GroundingStreamDataset", anno_file=str(d / "g1.json"))]))
    (d / "g1.json").write_text(json.dumps([{"video_uid": "v0.mp4", "query": "thing",
                                            "timestamps": [[1.0, 2.0]]}]))
    # a peft adapter directory (B not zero; its projector, heads and lm_head from
    # another seed) that both packages' --lora_pretrained read
    cfg = aha_tiny()
    rng = np.random.default_rng(3)
    lora = {n: {"a": torch.as_tensor(rng.standard_normal((cfg.llm.num_layers, din, 16)) * 0.1,
                                     dtype=torch.float32),
                "b": torch.as_tensor(rng.standard_normal((cfg.llm.num_layers, 16, dout)) * 0.02,
                                     dtype=torch.float32)}
            for n, (din, dout) in proj_dims(cfg.llm).items() if n in LORA_PROJS}
    loader.save_adapter(str(d / "peft"), lora, 2.0,
                        loader.init_aha_params(cfg, seed=3, device="cpu"))
    return d


def base_flags(data, mix="mix.json", batch=2):
    return ["--model_preset", "tiny", "--dataset_config", str(data / mix), "--batch_size",
            str(batch), "--learning_rate", "1e-3", "--decode_workers", "1"]


def metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_port(flags, out):
    random.seed(0)
    return cmd_train(flags + ["--output_dir", str(out), "--device", "cpu"])


def run_jax(flags, out):
    random.seed(0)
    jax_cmd_train(flags + ["--output_dir", str(out)])


def assert_losses_match(port_out, jax_out, steps):
    got, ref = metrics(port_out), metrics(jax_out)
    assert [r["step"] for r in got] == [r["step"] for r in ref] == steps
    for g, r in zip(got, ref):
        for k in PARTS:
            np.testing.assert_allclose(g["train/" + k], r["train/" + k], atol=1e-4,
                                       err_msg=f"step {g['step']} {k}")
        assert g["perf/tokens"] > 0 and g["perf/step_ms"] > 0


def assert_trained_match(port_out, jstate):
    """Every trained leaf of the port's last checkpoint against JAX's final
    state, to 5e-4 of the leaf's largest magnitude; returns the leaves. AdamW
    scales each element's step by its own gradient's size, so an element whose
    gradient is near zero carries the two packages' f32 summation noise into a
    step near the full rate (the worst element here is 1.4e-4 of its leaf's
    largest value); a schedule, gradient or continuation fault moves the
    adapters' B leaves, which hold a few steps' worth, by whole percents."""
    trained = torch.load(ttrainer.latest_checkpoint(f"{port_out}/checkpoints"),
                         weights_only=True)["trained"]
    jtree = jax.device_get(jstate.tree)
    assert len(trained) > 20
    for name, leaf in trained.items():
        ref = jtree
        for k in name.split("/"):
            ref = ref[k]
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(leaf.float().numpy(), ref, rtol=0,
                                   atol=5e-4 * np.abs(ref).max(), err_msg=name)
    return trained


CASES = {
    "int8-dots": ["--quantize_base", "--remat_policy", "dots", "--grad_accum_steps", "1"],
    "int4-dots_no_batch-lora_pretrained": ["--quantize_base", "--quantize_bits", "4",
                                           "--remat_policy", "dots_no_batch",
                                           "--grad_accum_steps", "1", "--lora_pretrained",
                                           "PEFT"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cmd_train_matches_jax(data, tmp_path, held_equal, jax_states, case):
    """Four micro-steps at accumulation 1: steps 3 and 4 follow updates at a
    non-zero rate, and the last checkpoint holds the fourth."""
    flags = [str(data / "peft") if f == "PEFT" else f
             for f in base_flags(data) + CASES[case] + ["--num_steps", "4"]]
    state = run_port(flags, tmp_path / "port")
    run_jax(flags, tmp_path / "jax")
    assert_losses_match(tmp_path / "port", tmp_path / "jax", [1, 2, 3, 4])
    assert state.step == 4 and state.opt_state.count == 4
    ckpt = ttrainer.latest_checkpoint(str(tmp_path / "port" / "checkpoints"))
    assert ckpt.endswith("step_00000004.pt") and os.listdir(tmp_path / "jax" / "checkpoints")
    trained = assert_trained_match(tmp_path / "port", jax_states[-1])
    # the adapters moved from where they started: zeros, or the directory's
    start = (loader.load_adapter(str(data / "peft"), aha_tiny(), device="cpu")[0]["q_proj"]["b"]
             if case.endswith("lora_pretrained") else torch.zeros_like(trained["lora/q_proj/b"]))
    assert not torch.equal(trained["lora/q_proj/b"], start)
    exported = torch.load(tmp_path / "port" / "adapter.pt", weights_only=True)
    assert "lora/q_proj/b" in exported and "model/llm/lm_head/kernel" in exported
    layers = state.tree["model"]["llm"]["layers"]
    kernel = layers["qkv_proj"]["kernel"]          # the trunk stays quantised and merged
    assert ("q4value" if "int4" in case else "qvalue") in kernel


def test_cmd_train_resume_matches_jax(data, tmp_path, held_equal, jax_states):
    """The dense trunk with gradient accumulation over 4 micro-steps (two
    updates, the second at a non-zero rate), then the same command resumed
    from ``latest_checkpoint`` to 6 (into another output directory: JAX's
    orbax export refuses to overwrite its own): the steps continue from 4 (two
    updates), every step's losses are JAX's, and so are the trained leaves of
    both runs' last checkpoints."""
    flags = base_flags(data) + ["--grad_accum_steps", "2"]
    for run, out in ((run_port, tmp_path / "port"), (run_jax, tmp_path / "jax")):
        run(flags + ["--num_steps", "4"], out)
        latest = sorted(os.listdir(out / "checkpoints"))[-1]
        state = run(flags + ["--num_steps", "6", "--resume_from_checkpoint",
                             str(out / "checkpoints" / latest)], f"{out}_resumed")
    assert state is None            # JAX's command returns nothing; the port's its state
    assert_losses_match(tmp_path / "port", tmp_path / "jax", [1, 2, 3, 4])
    assert_losses_match(f"{tmp_path / 'port'}_resumed", f"{tmp_path / 'jax'}_resumed", [5, 6])
    assert_trained_match(tmp_path / "port", jax_states[0])
    assert_trained_match(f"{tmp_path / 'port'}_resumed", jax_states[1])
    resumed = torch.load(ttrainer.latest_checkpoint(f"{tmp_path / 'port'}_resumed/checkpoints"),
                         weights_only=True)
    assert resumed["step"] == 6 and resumed["opt_state"]["count"] == 3


def test_resumed_run_equals_uninterrupted(data, tmp_path, held_equal, monkeypatch):
    """One example, so every batch is the same: a 4-step run cut after step 2
    and resumed from its checkpoint gives the uninterrupted run's steps 3 and 4
    and its trained leaves, bit for bit (the schedule, the moments, the
    accumulator and the step come back)."""
    flags = base_flags(data, "one.json", 1) + ["--grad_accum_steps", "2", "--num_steps", "4",
                                              "--quantize_base", "--quantize_bits", "4"]
    run_port(flags, tmp_path / "whole")
    train = ttrainer.train

    def cut(cfg, tc, params, batches, **kw):
        return train(cfg, tc, params, itertools.islice(batches, 2), **kw)

    monkeypatch.setattr(ttrainer, "train", cut)
    assert run_port(flags, tmp_path / "cut").step == 2
    monkeypatch.setattr(ttrainer, "train", train)
    latest = ttrainer.latest_checkpoint(str(tmp_path / "cut" / "checkpoints"))
    state = run_port(flags + ["--resume_from_checkpoint", latest], tmp_path / "cut")
    assert state.step == 4 and state.opt_state.count == 2
    whole, resumed = metrics(tmp_path / "whole"), metrics(tmp_path / "cut")
    assert [r["step"] for r in resumed] == [1, 2, 3, 4]
    for a, b in zip(whole, resumed):
        assert {k: a[k] for k in a if k.startswith("train/")} == {
            k: b[k] for k in b if k.startswith("train/")}
    a, b = (torch.load(p / "adapter.pt", weights_only=True)
            for p in (tmp_path / "whole", tmp_path / "cut"))
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("flags,item", [
    pytest.param(["--mesh_model", "2"], "mesh 1x2 needs 2 ranks; start it with torchrun "
                 "--nproc_per_node 2", id="flags0-item 12"),
    pytest.param(["--mesh_data", "4"], "mesh 4x1 needs 4 ranks; start it with torchrun "
                 "--nproc_per_node 4", id="flags1-item 12"),
    pytest.param(["--mesh_pipe", "2", "--pipe_microbatches", "4"], "mesh 1x1x2 needs 2 ranks; "
                 "start it with torchrun --nproc_per_node 2", id="flags2-item 12"),
    pytest.param(["--wandb"], "Do not port", id="flags3-Do not port")])
def test_refused_flags_exit_2(data, tmp_path, capsys, flags, item):
    """In one process, without a world of the mesh's size, the mesh flags exit
    2 naming the ranks the mesh needs (they run under torchrun:
    tests/test_torch_dist_cli.py); --wandb stays refused."""
    argv = ["train", "--device", "cpu", *base_flags(data), "--num_steps", "1",
            "--output_dir", str(tmp_path), *flags]
    assert main(argv) == 2
    assert item in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "metrics.jsonl")


def test_epochs_and_the_adapter_warning(data, tmp_path, capsys, held_equal):
    """--num_epochs counts len(dataset) // batch_size micro-steps an epoch;
    an adapter whose alpha / r is not the training config's is warned about;
    neither --num_steps nor --num_epochs is a usage error."""
    peft = tmp_path / "peft4"
    lora = loader.load_adapter(str(data / "peft"), aha_tiny(), device="cpu")[0]
    loader.save_adapter(str(peft), lora, 4.0)
    flags = base_flags(data, batch=3) + ["--grad_accum_steps", "1", "--lora_pretrained",
                                         str(peft)]
    state = run_port(flags + ["--num_epochs", "2"], tmp_path / "out")
    assert state.step == 2 * (4 // 3)
    assert "warning: adapter alpha/r scale 4.0" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        cmd_train(base_flags(data) + ["--device", "cpu"])
