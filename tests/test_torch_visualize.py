"""``visualize`` and its driver (aha_tpu_torch/drivers/visualize.py) on the
CPU against the JAX package: ``align_gt_to_pred`` bit for bit for each gold
format, the published baselines, ``hisum_sota_figure``'s metrics, and the
command's three functions (``pred_vs_gt`` on a TVSum TSV, a HiSum h5 and a
JSON gold; ``tvsum_sota``; ``hisum_sota``): the printed output and the files
written, by name, equal to JAX's command's on the same flags."""

import json
import os

import numpy as np
import pytest

from aha_tpu.cli import evaluate as jcli
from aha_tpu.drivers import visualize as jviz

from aha_tpu_torch.cli import evaluate as tcli
from aha_tpu_torch.drivers import visualize as viz

h5py = pytest.importorskip("h5py")
pytest.importorskip("matplotlib")

PARAMS = {"tvsum": {"alpha": 0.6, "beta": 1.2, "epsilon": 0.1, "uncertainty_threshold": 0.4},
          "hisum": {"alpha": 0.3, "beta": 0.8, "epsilon": 0.05, "uncertainty_threshold": 0.6}}


def _debug(rng, n):
    return [{"time": float(t), "informative_score": float(rng.random()),
             "relevance_score": float(rng.random()),
             "uncertainty_score": float(rng.random() * 2)} for t in range(n)]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Four videos: predictions (TVSum format with h5 ids and categories), a
    TVSum annotation TSV (20 annotators, per source frame), a HiSum h5 and a
    JSON gold, the parameters, and an evaluate metrics file."""
    d = tmp_path_factory.mktemp("viz")
    rng = np.random.default_rng(0)
    preds, tsv, js = [], [], {}
    with h5py.File(d / "gold.h5", "w") as hdf:
        for i in range(4):
            n, src = 12 + 3 * i, 60 + 10 * i
            uid = f"vid{i}"
            preds.append({"video_uuid": uid, "debug_data": _debug(rng, n),
                          "true_frames_list": [int(t * src / n) for t in range(n)],
                          "h5_identifier": f"video_{i}",
                          "categories": ["sports"] if i % 2 else ["news", "sports"]})
            for _ in range(20):
                tsv.append(f"{uid}\tGA\t{','.join(str(int(x)) for x in rng.integers(1, 6, src))}")
            hdf.create_group(f"video_{i}").create_dataset("gtscore", data=rng.random(n + 2))
            js[uid] = rng.random(n).tolist()
    (d / "pred.json").write_text(json.dumps(preds))
    (d / "anno.tsv").write_text("\n".join(tsv) + "\n")
    (d / "gold.json").write_text(json.dumps(js))
    (d / "params.json").write_text(json.dumps(PARAMS))
    (d / "metrics.json").write_text(json.dumps({"mAP@50": 0.61, "mAP@15": 0.32,
                                                "top5_mAP": 0.77, "f1": 0.5}))
    return d


def test_baselines_match_jax():
    assert viz.HISUM_PUBLISHED_BASELINES == jviz.HISUM_PUBLISHED_BASELINES


@pytest.mark.parametrize("kind", ["tvsum_tsv", "hisum_h5", "json"])
def test_align_gt_to_pred_matches_jax(files, kind):
    preds = json.loads((files / "pred.json").read_text())
    rng = np.random.default_rng(1)
    for p in preds + [{"video_uuid": "bare", "debug_data": []}]:
        gt = rng.random(80)
        got, off = viz.align_gt_to_pred(p, gt, kind)
        ref, joff = jviz.align_gt_to_pred(p, gt, kind)
        assert off == joff
        np.testing.assert_array_equal(got, ref)


def test_hisum_sota_figure_matches_jax(files, tmp_path):
    got = viz.hisum_sota_figure(str(files / "pred.json"), str(files / "gold.h5"),
                                PARAMS["hisum"], str(tmp_path / "a.png"))
    ref = jviz.hisum_sota_figure(str(files / "pred.json"), str(files / "gold.h5"),
                                 PARAMS["hisum"], str(tmp_path / "b.png"))
    assert got == ref and "per_category_mAP@50" in got
    assert (tmp_path / "a.png").stat().st_size > 0


# function -> its flags beyond --output
RUNS = {
    "pred_vs_gt-tsv": ["--func", "pred_vs_gt", "--pred_file", "pred.json", "--gold_file",
                       "anno.tsv", "--params_file", "params.json", "--max_show", "3"],
    "pred_vs_gt-h5": ["--func", "pred_vs_gt", "--pred_file", "pred.json", "--gold_file",
                      "gold.h5", "--params_file", "params.json", "--params_key", "hisum"],
    "pred_vs_gt-json": ["--func", "pred_vs_gt", "--pred_file", "pred.json", "--gold_file",
                        "gold.json", "--params_file", "params.json"],
    "tvsum_sota": ["--func", "tvsum_sota", "--metrics_file", "metrics.json"],
    "hisum_sota": ["--func", "hisum_sota", "--pred_file", "pred.json", "--gold_file", "gold.h5",
                   "--params_file", "params.json"],
}


@pytest.mark.parametrize("run", sorted(RUNS))
def test_cmd_visualize_matches_jax(files, tmp_path, capsys, run):
    outs = []
    for name, cmd in (("port", tcli.cmd_visualize), ("jax", jcli.cmd_visualize)):
        out_dir = tmp_path / name
        argv = [str(files / a) if (files / a).exists() else a for a in RUNS[run]]
        cmd(argv + ["--output", str(out_dir)])
        printed = capsys.readouterr().out.replace(str(out_dir), "<out>")
        outs.append((printed, sorted(os.listdir(out_dir))))
    assert outs[0] == outs[1]
    assert outs[0][1], "no figure written"
