"""The port's train command on gloo worlds of 2 ranks (tests/_torch_world.py)
against the same command in one process, and the multi-process dryrun:

  * ``train --mesh_data 2``: each rank loads its own rows (per-host loading),
    losses within 1e-4 of one process's at every step;
  * ``train --mesh_data 2 --batch_size 3``: a batch the data axis does not
    divide, loaded whole by every rank and held whole on each (as JAX's
    ``shard_batch`` leaves it), losses within 1e-4 of one process's;
  * ``train --mesh_pipe 2``: GPipe over 2 stages, replicated loading;
  * a run sharded over 2 ranks, resumed in one process from its checkpoint,
    continues as the uninterrupted one-process run does (the checkpoint is
    the file one card writes);
  * ``python -m aha_tpu_torch.dryrun_multichip --n 4 --device cpu`` exits 0
    with its lines.
"""

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from aha_tpu_torch.cli.train import cmd_train
from aha_tpu_torch.parallel.launch import start

cv2 = pytest.importorskip("cv2")

PARTS = ("total_loss", "lm_loss", "video_loss", "info_loss", "ref_loss", "tv_loss",
         "uncertainty_loss")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    d = tmp_path_factory.mktemp("dist_train")
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
    # two equal examples: every batch is the same, whichever the shuffle
    (d / "same.json").write_text(json.dumps([
        dict(entry, dataset_cls="GroundingStreamDataset", anno_file=str(d / "g2.json"))]))
    (d / "g2.json").write_text(json.dumps([{"video_uid": "v0.mp4", "query": "thing",
                                            "timestamps": [[1.0, 2.0]]}] * 2))
    return d


def flags(data, out, steps, *extra, mix="mix.json"):
    return ["--model_preset", "tiny", "--dataset_config", str(data / mix),
            "--batch_size", "2", "--learning_rate", "1e-3", "--decode_workers", "1",
            "--grad_accum_steps", "1", "--quantize_base", "--num_steps", str(steps),
            "--output_dir", str(out), "--device", "cpu", *extra]


def metrics(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def run_one(argv):
    random.seed(0)
    return cmd_train(argv)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The two-rank runs (one world at a time, beside the one-process runs)."""
    import _torch_world

    out = tmp_path_factory.mktemp("runs")
    runs = {
        "data2": flags(data, out / "data2", 2, "--mesh_data", "2"),
        "pipe2": flags(data, out / "pipe2", 3, "--mesh_data", "1", "--mesh_pipe", "2",
                       "--pipe_microbatches", "2"),
        "cut": flags(data, out / "cut", 2, "--mesh_data", "2", mix="same.json"),
        "data2_b3": flags(data, out / "data2_b3", 2, "--mesh_data", "2", "--batch_size", "3"),
    }
    one = [flags(data, out / "one", 3), flags(data, out / "whole", 4, mix="same.json"),
           flags(data, out / "one_b3", 2, "--batch_size", "3")]
    for name, argv in runs.items():
        world = start(_torch_world.run, 2, [("train", "train_cli", dict(argv=argv))],
                      timeout=240)
        if one:
            run_one(one.pop(0))
        assert world.result()[0]["train"] == (3 if name == "pipe2" else 2)
    return out


def assert_losses_equal(got, want):
    assert [r["step"] for r in got] == [r["step"] for r in want]
    for g, r in zip(got, want):
        for k in PARTS:
            np.testing.assert_allclose(g["train/" + k], r["train/" + k], atol=1e-4,
                                       err_msg=f"step {g['step']} {k}")


@pytest.mark.parametrize("case", ["data2", "pipe2"])
def test_train_command_sharded(runs, case):
    """--mesh_data 2 (per-host loading: each rank decodes its row) and
    --mesh_pipe 2 (replicated loading) over two ranks: rank 0's metrics equal
    one process's, step by step; the adapter is the one-card file."""
    got = metrics(runs / case)
    assert_losses_equal(got, metrics(runs / "one")[:len(got)])
    a = torch.load(runs / case / "adapter.pt", weights_only=True)
    assert len(a) > 20 and all(torch.isfinite(t).all() for t in a.values())


def test_train_batch_the_data_axis_does_not_divide(runs):
    """--mesh_data 2 --batch_size 3 over two ranks: every rank loads the whole
    batch and holds every row (the data axis does not divide it), its loss and
    gradients are the whole batch's and nothing is summed over ``data``; rank
    0's losses equal one process's at batch 3, step by step."""
    got = metrics(runs / "data2_b3")
    assert [r["step"] for r in got] == [1, 2]
    assert_losses_equal(got, metrics(runs / "one_b3"))
    a = torch.load(runs / "data2_b3" / "adapter.pt", weights_only=True)
    assert len(a) > 20 and all(torch.isfinite(t).all() for t in a.values())


def test_sharded_run_resumes_on_one_rank(runs, data):
    """A two-rank run over a mixture whose batches are all alike, cut after
    step 2; its last checkpoint (every leaf whole, written by rank 0) resumed
    in one process to 4 steps gives the uninterrupted one-process run's steps
    3 and 4 (the schedule, the moments and the step come back)."""
    assert_losses_equal(metrics(runs / "cut"), metrics(runs / "whole")[:2])
    ckpt = runs / "cut" / "checkpoints" / "step_00000002.pt"
    state = run_one(flags(data, runs / "resumed", 4, "--resume_from_checkpoint", str(ckpt),
                          mix="same.json"))
    assert state.step == 4 and state.opt_state.count == 4
    assert_losses_equal(metrics(runs / "resumed"), metrics(runs / "whole")[2:])


def test_dryrun_multichip_cpu():
    res = subprocess.run([sys.executable, "-m", "aha_tpu_torch.dryrun_multichip", "--n", "4",
                          "--device", "cpu"], capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = [x for x in res.stdout.splitlines() if x.startswith("dryrun_multichip(4)")]
    assert len(lines) == 8, res.stdout
    for what in ("mesh=", "QLoRA", "GPipe", "ring-attention", "serve_step", "inference ok",
                 "continuous-batching", "7B-shape"):
        assert any(what in x for x in lines), what
