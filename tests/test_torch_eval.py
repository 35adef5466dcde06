"""The port's evaluation chain on the host against the JAX package's, in one
process: every function of ``aha_tpu_torch/ops/signal.py`` and
``aha_tpu_torch/eval`` (scoring, tvsum, hisum, grounding, grid_search,
highlight, qvh, captioning, soda) on inputs made from numpy seeds gives JAX's
outputs, bit for bit (the torch Savitzky-Golay filter in f32 within 1e-6);
the port's ``grid-search``, ``evaluate`` (all five functions) and
``highlight`` commands on prediction files in the format of JAX's ``infer``
write and print what JAX's commands write and print; and the offline
baseline driver (``run_offline_baseline``) on sessions that both command
lines build from the same flags gives JAX's answers."""

import json
import math
import random
import types

import numpy as np
import pytest
import torch

from aha_tpu.cli import evaluate as jcli
from aha_tpu.cli import infer as jinfer
from aha_tpu.eval import captioning as jcaptioning
from aha_tpu.eval import grid_search as jgrid
from aha_tpu.eval import grounding as jgrounding
from aha_tpu.eval import highlight as jhighlight
from aha_tpu.eval import hisum as jhisum
from aha_tpu.eval import qvh as jqvh
from aha_tpu.eval import scoring as jscoring
from aha_tpu.eval import soda as jsoda
from aha_tpu.eval import tvsum as jtvsum
from aha_tpu.ops import signal as jsignal

from aha_tpu_torch.cli import evaluate as tcli
from aha_tpu_torch.cli import infer as tinfer
from aha_tpu_torch.cli import main
from aha_tpu_torch.eval import captioning, grid_search, grounding, highlight, hisum, qvh, scoring
from aha_tpu_torch.eval import soda, tvsum
from aha_tpu_torch.ops import signal

PORT = types.SimpleNamespace(signal=signal, scoring=scoring, tvsum=tvsum, hisum=hisum,
                             grounding=grounding, grid=grid_search, highlight=highlight, qvh=qvh,
                             captioning=captioning, soda=soda)
JAX = types.SimpleNamespace(signal=jsignal, scoring=jscoring, tvsum=jtvsum, hisum=jhisum,
                            grounding=jgrounding, grid=jgrid, highlight=jhighlight, qvh=jqvh,
                            captioning=jcaptioning, soda=jsoda)

WORDS = ["a", "man", "rides", "his", "bike", "down", "the", "hill", "dog", "runs", "fast",
         "red", "car", "turns", "left", "cooking", "pasta", "riding", "cooks", "dogs"]


def same(got, ref, rtol=0.0):
    """Equal structure and values: bit for bit where rtol is 0 (nan equal to
    nan), else within rtol."""
    if isinstance(ref, dict):
        assert isinstance(got, dict) and list(got) == list(ref), (list(got), list(ref))
        for k in ref:
            same(got[k], ref[k], rtol)
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), (got, ref)
        for a, b in zip(got, ref):
            same(a, b, rtol)
    elif isinstance(ref, np.ndarray):
        got = np.asarray(got)
        assert got.shape == ref.shape and got.dtype == ref.dtype, (got, ref)
        if rtol:
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=0)
        else:
            np.testing.assert_array_equal(got, ref)
    elif isinstance(ref, (float, np.floating)) and not isinstance(ref, bool):
        assert isinstance(got, (float, np.floating)), (got, ref)
        if math.isnan(ref):
            assert math.isnan(got)
        elif rtol:
            assert got == pytest.approx(ref, rel=rtol, abs=0)
        else:
            assert got == ref, (got, ref)
    else:
        assert type(got) is type(ref) and got == ref, (got, ref)


def both(case):
    """The case on the port and on JAX, from the same seeded inputs."""
    return case(PORT), case(JAX)


def rng(seed):
    return np.random.default_rng(seed)


def trace(seed, n=40, unc=0.2):
    """A debug_data list: 0.5 s frames, seeded scores."""
    r = rng(seed)
    return [dict(time=0.5 * t, informative_score=float(r.random()),
                 relevance_score=float(r.random()), uncertainty_score=float(r.random() * unc))
            for t in range(n)]


def sentence(r, n):
    return " ".join(r.choice(WORDS) for _ in range(n))


# -- ops/signal.py -------------------------------------------------------------------------


SIGNAL = {
    "savgol_coeffs": lambda m: [m.signal.savgol_coeffs(w, p)
                                for w, p in ((5, 2), (7, 3), (15, 3), (31, 4))],
    "savgol_filter": lambda m: [m.signal.savgol_filter(rng(n).normal(size=n).cumsum(), 15, 3)
                                for n in (15, 40, 200)],
    "savgol_filter-short": lambda m: [m.signal.savgol_filter(rng(n).normal(size=n), 15, 3)
                                      for n in (4, 9, 14)],
    "savgol_filter-window-9": lambda m: m.signal.savgol_filter(rng(1).random(50), 9, 2),
    "find_peaks": lambda m: [
        m.signal.find_peaks(np.convolve(rng(s).normal(size=120), np.ones(5) / 5, "same"), **kw)
        for s in range(4) for kw in ({}, {"height": 0.1}, {"prominence": 0.2},
                                      {"distance": 7},
                                      {"height": 0.0, "prominence": 0.1, "distance": 10})],
    "find_peaks-plateaus": lambda m: [m.signal.find_peaks(np.round(rng(s).random(80), 1),
                                                          distance=3) for s in range(3)],
    "_prominences": lambda m: m.signal._prominences(
        rng(3).random(60), np.arange(1, 59, 4)),
    "find_ticks": lambda m: [m.signal.find_ticks(
        np.abs(np.convolve(rng(s).normal(size=300), np.ones(9) / 9, "same")), fps)
        for s, fps in ((0, 2.0), (1, 1.0), (2, 0.5))],
    "find_ticks-thresh": lambda m: m.signal.find_ticks(rng(4).random(100), 1.0,
                                                       min_separation=5, thresh=0.5),
}


@pytest.mark.parametrize("case", list(SIGNAL))
def test_signal_matches_jax(case):
    same(*both(SIGNAL[case]))


@pytest.mark.parametrize("shape,window,order", [((60,), 15, 3), ((3, 60), 15, 3),
                                                ((2, 4, 33), 7, 2), ((5, 200), 31, 4)])
def test_savgol_filter_torch_matches_jax(shape, window, order):
    """The tensor filter against JAX's ``savgol_filter_jnp`` on the same f32
    input (1e-6), and against the host filter in f64 (1e-6 as well: the host fits
    each edge with ``polyfit``)."""
    import jax.numpy as jnp

    x = rng(len(shape)).normal(size=shape).cumsum(axis=-1)
    x32 = x.astype(np.float32)
    got = signal.savgol_filter_torch(torch.from_numpy(x32), window, order)
    assert got.dtype == torch.float32 and got.shape == shape
    ref = np.asarray(jsignal.savgol_filter_jnp(jnp.asarray(x32), window, order))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)
    got64 = signal.savgol_filter_torch(torch.from_numpy(x), window, order).numpy()
    host = np.stack([jsignal.savgol_filter(r, window, order) for r in x.reshape(-1, shape[-1])])
    np.testing.assert_allclose(got64.reshape(-1, shape[-1]), host, rtol=1e-6, atol=1e-6)


# -- eval/scoring.py -----------------------------------------------------------------------


def _combos(r, C=7):
    return (r.random(C) * 1.5, r.random(C) * 1.5, r.random(C) * 10 - 5, r.random(C) * 0.2)


def _qvh_example(seed, n=12):
    r = rng(seed)
    ids = sorted(r.choice(70, n, replace=False).tolist())
    return {"answer": {"relevant_clip_ids": ids,
                       "saliency_scores": r.integers(0, 5, (n, 3)).tolist()}}


SCORING = {
    "combined_score-scalars": lambda m: m.scoring.combined_score(
        *rng(0).random((3, 50)), 0.7, 1.1, -2.0, 0.08),
    "combined_score-combo-axis": lambda m: m.scoring.combined_score(
        *rng(1).random((3, 50)), *_combos(rng(2))),
    "traces_from_debug_data": lambda m: m.scoring.traces_from_debug_data(
        trace(3) + [{"time": 20.0}]),
    "smooth_pred_list": lambda m: [m.scoring.smooth_pred_list(rng(4).random((3, 30)), w)
                                   for w in (0, 1, 4, 40)],
    "normalize_pred_list": lambda m: [m.scoring.normalize_pred_list(x) for x in (
        rng(5).random((4, 30)), np.ones(10), rng(6).random(17) * 8 - 4)],
    "is_time_in_span": lambda m: [m.scoring.is_time_in_span(t, [[1, 3], [7.5, 9]])
                                  for t in np.arange(0, 10, 0.5)],
    "times_in_spans": lambda m: m.scoring.times_in_spans(np.arange(0, 30, 0.5),
                                                         [[1, 3], [7.5, 9], [20, 40]]),
    "keep_longest_true_span": lambda m: [m.scoring.keep_longest_true_span(rng(s).random(40) > 0.4)
                                         for s in range(5)] + [
        m.scoring.keep_longest_true_span(np.zeros(5, bool))],
    "mask_iou": lambda m: [m.scoring.mask_iou(rng(s).random(30) > 0.5, rng(s + 9).random(30) > 0.6)
                           for s in range(4)] + [m.scoring.mask_iou(np.zeros(3, bool),
                                                                    np.zeros(3, bool))],
    "span_iou": lambda m: [m.scoring.span_iou(a, b) for a, b in (
        ((0, 5), (3, 9)), ((0, 2), (5, 9)), ((4, 4), (4, 4)), ((1, 10), (2, 3)))],
    "temporal_iou": lambda m: [m.scoring.temporal_iou(a, b) for a, b in (
        ((0.0, 5.5), (3.0, 9.0)), ((0, 2), (5, 9)), ((4, 4), (4, 4)), ((1.5, 10), (2, 3)))],
    "qvh_to_charades_format": lambda m: [m.scoring.qvh_to_charades_format(_qvh_example(s))
                                         for s in range(5)],
    "average_precision": lambda m: [m.scoring.average_precision(
        rng(s).integers(0, 2, (3, 25)), rng(s + 1).random((3, 25))) for s in range(4)] + [
        m.scoring.average_precision(np.zeros(6), rng(7).random(6)),
        m.scoring.average_precision(np.array([1, 0, 1, 1]), np.array([0.5, 0.5, 0.2, 0.5]))],
}


@pytest.mark.parametrize("case", list(SCORING))
def test_scoring_matches_jax(case):
    same(*both(SCORING[case]))


# -- eval/tvsum.py, eval/hisum.py ----------------------------------------------------------


def write_tvsum_annotations(path, videos: dict, seed=0, annotators=20):
    """A TVSum annotation TSV: ``annotators`` rows a video of 1-5 scores per
    source frame; videos: {id: (category, n source frames)}."""
    r = rng(seed)
    with open(path, "w") as f:
        for vid, (cat, n) in videos.items():
            for _ in range(annotators):
                f.write(f"{vid}\t{cat}\t" + ",".join(str(x) for x in r.integers(1, 6, n)) + "\n")
    return str(path)


def _gt_pred(seed, n_videos=5, lengths=(30, 45, 1, 60, 23)):
    r = rng(seed)
    gt = {f"v{i}": r.integers(1, 6, lengths[i % len(lengths)]) / 5.0 for i in range(n_videos)}
    pred = {k: r.random(len(v)) for k, v in gt.items()}
    return gt, pred


TVSUM = {
    "binarize_gt": lambda m: [m.tvsum.binarize_gt(rng(s).random(n), rho)
                              for s, n in ((0, 30), (1, 7), (2, 1)) for rho in (0.15, 0.5)],
    "map_at_rho": lambda m: [m.tvsum.map_at_rho(rng(s).random(40), rng(s + 5).random(p), rho)
                             for s, p in ((0, 40), (1, (9, 40))) for rho in (0.15, 0.5)],
    "top_k_ap": lambda m: [m.tvsum.top_k_ap(rng(s).integers(0, 2, 30), rng(s + 1).random(p), k)
                           for s, p in ((0, 30), (1, (11, 30))) for k in (1, 5, 40)] + [
        m.tvsum.top_k_ap(np.zeros(8), rng(9).random(8))],
    "top5_map": lambda m: m.tvsum.top5_map(*_gt_pred(3)),
    "f1_at_rho": lambda m: [m.tvsum.f1_at_rho(rng(s).random(30), rng(s + 1).random(p), rho)
                            for s, p in ((0, 30), (1, (6, 30))) for rho in (0.15, 0.5)],
    "evaluate_f1": lambda m: m.tvsum.evaluate_f1(*_gt_pred(4)),
    "evaluate_tvsum": lambda m: m.tvsum.evaluate_tvsum(*_gt_pred(5)),
    "evaluate_tvsum_per_category": lambda m: m.tvsum.evaluate_tvsum_per_category(
        *_gt_pred(6), {f"v{i}": {"category_code": "BK" if i % 2 else "GA"} for i in range(5)}),
}

HISUM = {
    "segment_into_shots": lambda m: [m.hisum.segment_into_shots(rng(s).random(shape), sl, fps)
                                     for s, shape, sl, fps in ((0, 30, 1, 1), (1, 31, 2, 2),
                                                               (2, (4, 29), 3, 1))],
    "map_at_rho": lambda m: [m.hisum.map_at_rho(rng(s).random(50), rng(s + 1).random(p), rho)
                             for s, p in ((0, 50), (1, (6, 50))) for rho in (0.15, 0.5)],
    "mean_average_precision": lambda m: [m.hisum.mean_average_precision(*_gt_pred(7), rho)
                                         for rho in (0.15, 0.5)],
    "f1_budget": lambda m: [m.hisum.f1_budget(rng(s).random(n), rng(s + 1).random(n), b, sl)
                            for s, n in ((0, 60), (1, 17)) for b, sl in ((0.15, 1), (0.3, 2))],
    "evaluate_scores": lambda m: [m.hisum.evaluate_scores(*_gt_pred(8, lengths=(30, 45, 20, 60)),
                                                          spearman_kendall=sk)
                                  for sk in (False, True)],
}


@pytest.mark.parametrize("case", list(TVSUM))
def test_tvsum_matches_jax(case):
    same(*both(TVSUM[case]))


def test_tvsum_load_annotations_matches_jax(tmp_path):
    """20 annotators a video (the mean, then / 5), and a video with 3."""
    path = write_tvsum_annotations(tmp_path / "anno.tsv", {"a": ("GA", 50), "b": ("BK", 31)})
    with open(path, "a") as f:
        f.write("c\tVT\t1,5,3\nc\tVT\t2,2,2\nc\tVT\t5,5,1\n")
    got, ref = tvsum.load_annotations(path), jtvsum.load_annotations(path)
    same(got, ref)
    assert len(got["a"]["importance_scores"]) == 50


@pytest.mark.parametrize("case", list(HISUM))
def test_hisum_matches_jax(case):
    same(*both(HISUM[case]))


# -- eval/grounding.py, eval/grid_search.py ------------------------------------------------


def grounding_preds(seed, n=4):
    r = rng(seed)
    preds, golds = [], {}
    for i in range(n):
        T = int(r.integers(20, 40))
        preds.append({"question_id": f"q{i}", "debug_data": trace(seed * 10 + i, T)})
        s = float(r.uniform(0, T / 2 - 3))
        golds[f"q{i}"] = {"question_id": f"q{i}", "timestamps": [[s, s + float(r.uniform(1, 6))]]}
    return preds, golds


def tvsum_preds(seed, n=6, frames=40, src=200):
    r = rng(seed)
    preds, gts = [], {}
    for v in range(n):
        vid = f"v{v}"
        gts[vid] = {"importance_scores": r.random(src).tolist(), "category_code": "GA",
                    "video_uid": vid}
        preds.append({"video_uuid": vid, "debug_data": trace(seed * 10 + v, frames),
                      "true_frames_list": list(range(0, src, src // frames))})
    return preds, gts


def hisum_preds(seed, n=4):
    r = rng(seed)
    preds, gtscores = [], {}
    for v in range(n):
        T = int(r.integers(20, 35))
        preds.append({"video_uuid": f"yt{v}", "h5_identifier": f"video_{v}",
                      "debug_data": trace(seed * 10 + v, T)})
        gtscores[f"video_{v}"] = r.random(T + int(r.integers(-3, 4)))
    return preds, gtscores


SMALL_GRID = {"alpha": np.linspace(0, 1.5, 4), "beta": np.linspace(0, 1.5, 3),
              "epsilon": np.linspace(-5, 5, 5), "uncertainty_threshold": np.linspace(0.04, 0.15, 3)}

GROUNDING = {
    "per_video_ious": lambda m: [m.grounding.per_video_ious(
        trace(s, 30), [[2.0, 6.5], [10, 12]], 0.5, 1.0, -2.0, 0.05, smooth_window=w)
        for s in range(2) for w in (0, 3)],
    "summarize": lambda m: m.grounding.summarize(rng(1).random(17)),
    "evaluate_grounding": lambda m: m.grounding.evaluate_grounding(
        *grounding_preds(2), 0.4, 1.2, 1.0, 0.07, smooth_windows=range(0, 4)),
    "grid_score_r05": lambda m: m.grounding.grid_score_r05(
        *grounding_preds(3), *m.grid.combo_arrays(SMALL_GRID)),
    "THRESHOLDS": lambda m: m.grounding.THRESHOLDS,
}

GRID = {
    "DEFAULT_GRID": lambda m: m.grid.DEFAULT_GRID,
    "combo_arrays": lambda m: m.grid.combo_arrays(m.grid.DEFAULT_GRID),
    "tvsum_objective": lambda m: m.grid.tvsum_objective(
        *tvsum_preds(4), *m.grid.combo_arrays(SMALL_GRID)),
    "hisum_objective": lambda m: m.grid.hisum_objective(
        *hisum_preds(5), *m.grid.combo_arrays(SMALL_GRID)),
    "run_grid_search-tvsum-default-grid": lambda m: m.grid.run_grid_search(
        "tvsum", tvsum_preds(6, n=7)[0], ground_truths=tvsum_preds(6, n=7)[1], seed=3),
    "run_grid_search-tvsum_degraded-few-videos": lambda m: m.grid.run_grid_search(
        "tvsum_degraded", tvsum_preds(7, n=3)[0], ground_truths=tvsum_preds(7, n=3)[1],
        grid=SMALL_GRID, seed=0),
    "run_grid_search-hisum": lambda m: m.grid.run_grid_search(
        "hisum", hisum_preds(8)[0], gtscores=hisum_preds(8)[1], grid=SMALL_GRID),
    "run_grid_search-charades": lambda m: m.grid.run_grid_search(
        "charades", grounding_preds(9)[0], ground_truths=grounding_preds(9)[1], grid=SMALL_GRID),
}


@pytest.mark.parametrize("case", list(GROUNDING))
def test_grounding_matches_jax(case):
    same(*both(GROUNDING[case]))


@pytest.mark.parametrize("case", list(GRID))
def test_grid_search_matches_jax(case):
    same(*both(GRID[case]))


def test_run_grid_search_global_random_and_merge_match_jax(tmp_path):
    """seed None draws the shuffle from the global ``random`` (seeded alike
    before each side); the result merges into an existing params file under
    the dataset's key, the other keys kept; an unknown dataset raises."""
    preds, gts = tvsum_preds(10, n=8)
    outs = []
    for name, mod in (("port", grid_search), ("jax", jgrid)):
        path = tmp_path / name / "params.json"
        path.parent.mkdir()
        path.write_text(json.dumps({"hisum": {"alpha": 1.0}, "tvsum": {"alpha": 9.0}}))
        random.seed(1234)
        best = mod.run_grid_search("tvsum", preds, ground_truths=gts, grid=SMALL_GRID,
                                   save_path=str(path))
        outs.append((best, path.read_text()))
        with pytest.raises(ValueError, match="no grid-search objective"):
            mod.run_grid_search("youcook2", preds)
    same(outs[0], outs[1])
    assert json.loads(outs[0][1])["hisum"] == {"alpha": 1.0}


# -- eval/highlight.py ---------------------------------------------------------------------


HIGHLIGHT = {
    "knapsack_selection": lambda m: [m.highlight.knapsack_selection(rng(s).random(n) - 0.3, b)
                                     for s, n, b in ((0, 30, 10), (1, 12, 11), (2, 50, 3))],
    "knapsack_selection-ties": lambda m: m.highlight.knapsack_selection(
        np.round(rng(3).random(40), 1), 8),
    "frame_values": lambda m: m.highlight.frame_values(trace(4), 0.3, 1.2, -0.7),
    "expand_selection": lambda m: [m.highlight.expand_selection(
        set(rng(s).choice(40, 6, replace=False).tolist()), list(range(0, 400, 10)), fps, 395)
        for s, fps in ((0, 30.0), (1, 7.0), (2, 1.0))],
    "generate_highlight": lambda m: [m.highlight.generate_highlight(
        trace(s, 40), list(range(0, 1200, 30)), d, alpha=a, beta=b, epsilon=e, source_fps=30.0)
        for s, d, a, b, e in ((5, 10, 1.0, 1.0, 0.0), (6, 5, 0.0, -1.0, -5.0),
                              (7, 39, 0.5, 0.2, 3.0))],
}


@pytest.mark.parametrize("case", list(HIGHLIGHT))
def test_highlight_matches_jax(case):
    same(*both(HIGHLIGHT[case]))


def write_clip(path, n_frames=48, fps=8.0, size=(64, 48), seed=0):
    import cv2

    r = rng(seed)
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 9) % 255, np.uint8)
        frame[:12, :12] = r.integers(0, 255, (12, 12, 3))
        out.write(frame)
    out.release()
    return str(path)


def test_highlight_reel_and_params_match_jax(tmp_path):
    """``write_reel`` and ``generate_highlight`` with a reel: the same frames
    written, the reels' frames equal; ``load_calibrated_params`` of a params
    file; ``max_duration`` at the frame count refused alike."""
    import cv2

    clip = write_clip(tmp_path / "clip.mp4")
    dd = trace(8, 12)
    true_frames = list(range(0, 48, 4))
    reels = []
    for name, mod in (("port", highlight), ("jax", jhighlight)):
        reel = str(tmp_path / f"{name}.mp4")
        res = mod.generate_highlight(dd, true_frames, 4, alpha=1.0, beta=0.5, epsilon=0.1,
                                     source_fps=8.0, video_path=clip, output_path=reel)
        n = mod.write_reel(clip, [0, 3, 5, 47, 90], str(tmp_path / f"{name}-idx.mp4"))
        with pytest.raises(ValueError, match="max_duration"):
            mod.generate_highlight(dd, true_frames, 12, alpha=1.0, beta=0.5, epsilon=0.1,
                                   source_fps=8.0)
        with pytest.raises(IOError, match="cannot open"):
            mod.write_reel(str(tmp_path / "none.mp4"), [0], str(tmp_path / "x.mp4"))
        reels.append((res, n, reel))
    same(reels[0][:2], reels[1][:2])
    assert reels[0][0]["frames_written"] == len(reels[0][0]["highlight_indices"]) > 0
    assert reels[0][1] == 4
    caps = [cv2.VideoCapture(r) for _, _, r in reels]
    while True:
        (ok_a, fa), (ok_b, fb) = (c.read() for c in caps)
        assert ok_a == ok_b
        if not ok_a:
            break
        np.testing.assert_array_equal(fa, fb)
    params = tmp_path / "params.json"
    params.write_text(json.dumps({"tvsum": {"alpha": 0.5, "beta": -1.0, "epsilon": 2.5,
                                            "uncertainty_threshold": 0.1},
                                  "hisum": {"alpha": 1.0, "beta": 0.0, "epsilon": 0.0}}))
    for key in ("tvsum", "hisum"):
        assert highlight.load_calibrated_params(str(params), key) == \
            jhighlight.load_calibrated_params(str(params), key)


# -- eval/qvh.py ---------------------------------------------------------------------------


def qvh_data(seed, n=6):
    r = rng(seed)
    submission, ground_truth = [], []
    for q in range(n):
        start = float(r.integers(0, 30)) * 2
        gt_w = [start, start + float(r.integers(1, 40)) * 2]
        noise = float(r.normal() * 2)
        wins = [[gt_w[0] + noise, gt_w[1] + noise, 0.9], [0.0, 2.0, 0.1],
                [start + 3, start + 33, float(r.random())]]
        submission.append({"qid": q, "pred_relevant_windows": wins,
                           "pred_saliency_scores": r.random(75).tolist()})
        ids = list(range(int(gt_w[0] // 2), int(gt_w[1] // 2)))
        ground_truth.append({"qid": q, "duration": 150, "relevant_windows": [gt_w],
                             "relevant_clip_ids": ids,
                             "saliency_scores": r.integers(0, 5, (len(ids), 3)).tolist()})
    return submission, ground_truth


def _detections(seed):
    r = rng(seed)
    gt = [{"video-id": f"q{i % 3}", "t-start": float(s), "t-end": float(s + d)}
          for i, (s, d) in enumerate(zip(r.integers(0, 50, 8), r.integers(2, 20, 8)))]
    pred = [{"video-id": f"q{i % 4}", "t-start": float(s), "t-end": float(s + d),
             "score": float(r.random())}
            for i, (s, d) in enumerate(zip(r.integers(0, 50, 12), r.integers(2, 20, 12)))]
    return gt, pred


QVH = {
    "temporal_iou_paired": lambda m: m.qvh.temporal_iou_paired(
        np.sort(rng(0).random((9, 2)) * 10, 1), np.sort(rng(1).random((9, 2)) * 10, 1)),
    "temporal_iou_cross": lambda m: m.qvh.temporal_iou_cross(
        np.sort(rng(2).random((5, 2)) * 10, 1), np.sort(rng(3).random((7, 2)) * 10, 1)),
    "interpolated_precision_recall": lambda m: [m.qvh.interpolated_precision_recall(
        np.sort(rng(s).random(10))[::-1], np.sort(rng(s + 1).random(10))) for s in range(3)],
    "average_precision_detection": lambda m: [m.qvh.average_precision_detection(*_detections(s))
                                              for s in range(3)] + [
        m.qvh.average_precision_detection(_detections(4)[0], [])],
    "compute_mr_ap": lambda m: m.qvh.compute_mr_ap(*qvh_data(5)),
    "compute_mr_r1": lambda m: m.qvh.compute_mr_r1(*qvh_data(6)),
    "get_data_by_range": lambda m: [m.qvh.get_data_by_range(*qvh_data(7), r)
                                    for r in ([0, 10], [10, 30], [0, 150])],
    "eval_moment_retrieval": lambda m: m.qvh.eval_moment_retrieval(*qvh_data(8)),
    "get_ap": lambda m: [m.qvh.get_ap(rng(s).integers(0, 2, 20), rng(s + 1).random(20), interp)
                         for s in range(3) for interp in (True, False)] + [
        m.qvh.get_ap(np.zeros(5), rng(4).random(5)), m.qvh.get_ap(np.ones(5), rng(5).random(5))],
    "mk_gt_scores": lambda m: m.qvh.mk_gt_scores(qvh_data(9)[1][0]),
    "compute_hl": lambda m: [f({d["qid"]: d for d in sub},
                               {d["qid"]: (m.qvh.mk_gt_scores(d) >= 3).astype(float) for d in gt})
                             for sub, gt in [qvh_data(10)]
                             for f in (m.qvh.compute_hl_hit1, m.qvh.compute_hl_ap)],
    "eval_highlight": lambda m: m.qvh.eval_highlight(*qvh_data(11)),
    "find_continuous_positive_segments": lambda m: [
        m.qvh.find_continuous_positive_segments(np.maximum(rng(s).random(40) - 0.3, 0), k)
        for s in range(3) for k in (1, 2, 4)],
    "submission_from_debug_data": lambda m: m.qvh.submission_from_debug_data(
        [{"question_id": i, "debug_data": trace(12 + i, 30)} for i in range(3)]
        + [{"question_id": 9, "debug_data": []}],
        alpha=0.5, beta=1.0, epsilon=1.0, uncertainty_threshold=0.05,
        relevance_threshold=0.6, min_relevance_frames=2),
    "eval_submission": lambda m: m.qvh.eval_submission(*qvh_data(13)),
    "eval_submission-shared-qids": lambda m: m.qvh.eval_submission(
        qvh_data(14)[0][:4], qvh_data(14)[1][1:], match_number=False),
}


@pytest.mark.parametrize("case", list(QVH))
def test_qvh_matches_jax(case):
    same(*both(QVH[case]))


# -- eval/captioning.py, eval/soda.py ------------------------------------------------------


def _gts_res(seed, n=10, refs=2):
    r = rng(seed)
    gts = {str(i): [sentence(r, int(r.integers(4, 12))) for _ in range(refs)] for i in range(n)}
    res = {str(i): [sentence(r, int(r.integers(3, 12)))] for i in range(n)}
    res["0"] = [gts["0"][0]]
    return gts, res


CAPTIONING = {
    "_ngram_counts": lambda m: dict(m.captioning._ngram_counts(sentence(rng(0), 12))),
    "CiderScorer": lambda m: [(lambda sc: [sc.append(res[k][0], gts[k]) for k in sorted(gts)]
                               and sc.compute_score())(m.captioning.CiderScorer(n=n, sigma=s))
                              for gts, res in [_gts_res(1)] for n, s in ((4, 6.0), (2, 3.0))],
    "Cider": lambda m: m.captioning.Cider().compute_score(*_gts_res(2)),
    "ptb_tokenize_sentence": lambda m: [m.captioning.ptb_tokenize_sentence(s) for s in (
        "The man, quickly... ran!", "it's 50% off.", "A $5 (cheap) meal -- really?\nyes;",
        "don't stop: believin'")],
    "PTBTokenizer": lambda m: m.captioning.PTBTokenizer().tokenize(
        {"k": [{"caption": "Hello, World."}, {"caption": "Two  spaces, here!"}],
         "j": [{"caption": "it's ok"}]}),
    "_porter_light": lambda m: [m.captioning._porter_light(w) for w in (
        "riding", "rides", "cooked", "dogs", "boxes", "amazingly", "is", "studies", "tied")],
    "_align": lambda m: [m.captioning._align(sentence(rng(s), 9).split(),
                                             sentence(rng(s + 1), 10).split()) for s in range(4)],
    "meteor_sentence": lambda m: [m.captioning.meteor_sentence(res[k][0], gts[k])
                                  for gts, res in [_gts_res(3)] for k in sorted(gts)],
    "Meteor": lambda m: m.captioning.Meteor().compute_score(*_gts_res(4)),
}


class FakeMeteorJar:
    """A stand-in for the jar's stdio process: a stat line per SCORE line,
    then a score per segment and the aggregate."""

    def __init__(self):
        self.stdin = self
        self.stdout = self
        self.score_lines, self._out = [], []

    def write(self, data):
        line = data.decode().rstrip("\n")
        if line.startswith("SCORE"):
            self.score_lines.append(line)
            self._out.append(f"{len(self.score_lines)} 1 2\n")
        else:
            n = len(line.split(" ||| ")) - 1
            self._out += [f"{0.25 * (i + 1)}\n" for i in range(n)] + ["0.6\n"]

    def flush(self):
        pass

    def readline(self):
        return self._out.pop(0).encode()


@pytest.mark.parametrize("case", list(CAPTIONING))
def test_captioning_matches_jax(case):
    same(*both(CAPTIONING[case]))


def test_captioning_java_meteor_and_fallback_match_jax(monkeypatch, tmp_path):
    """JavaMeteor's stdio protocol on a stand-in process; find_java_meteor
    and build_meteor as the environment names a jar or not (the Python
    METEOR without one, an error when java is asked for and absent)."""
    gts = {"b": ["the dog runs", "a dog runs"], "a": ["hello world"], "c": ["x ||| y"]}
    res = {"b": ["the dog runs"], "a": ["hello there"], "c": ["x ||| y"]}
    outs = []
    for mod in (captioning, jcaptioning):
        fake = FakeMeteorJar()
        outs.append((mod.JavaMeteor(popen=fake).compute_score(gts, res), fake.score_lines))
    same(outs[0], outs[1])
    monkeypatch.delenv("AHA_METEOR", raising=False)
    monkeypatch.delenv("AHA_METEOR_JAR", raising=False)
    monkeypatch.delenv("JRE_BIN_JAVA", raising=False)
    monkeypatch.chdir(tmp_path)
    assert captioning.find_java_meteor() is None is jcaptioning.find_java_meteor()
    assert captioning.build_meteor().backend == jcaptioning.build_meteor().backend == "lite"
    jar = tmp_path / "meteor-1.5.jar"
    jar.write_bytes(b"")
    monkeypatch.setenv("AHA_METEOR_JAR", str(jar))
    monkeypatch.setenv("JRE_BIN_JAVA", "/bin/true")
    assert captioning.find_java_meteor() == jcaptioning.find_java_meteor() == ("/bin/true",
                                                                               str(jar))
    monkeypatch.setenv("AHA_METEOR", "lite")
    assert captioning.build_meteor().backend == jcaptioning.build_meteor().backend == "lite"
    monkeypatch.setenv("AHA_METEOR", "java")
    monkeypatch.setenv("AHA_METEOR_JAR", str(tmp_path / "none.jar"))
    for mod in (captioning, jcaptioning):
        with pytest.raises(RuntimeError, match="AHA_METEOR=java"):
            mod.build_meteor()


def _dvc_corpus(seed, n=3):
    r = rng(seed)
    out = {k: [] for k in ("ps", "gs", "pc", "gc", "sp", "keys")}
    for v in range(n):
        G, P = int(r.integers(2, 5)), int(r.integers(0, 5)) if v else 3
        out["gs"].append(np.sort(r.random((G, 2)) * 60, axis=1))
        out["ps"].append(np.sort(r.random((P, 2)) * 60, axis=1).reshape(-1, 2))
        out["gc"].append(np.asarray([sentence(r, int(r.integers(3, 8))) + "." for _ in range(G)]))
        out["pc"].append([sentence(r, int(r.integers(3, 8))) for _ in range(P)])
        out["sp"].append(np.asarray([1] * (G - 1) + [2]))
        out["keys"].append(f"vid{v}")
    return out


def _dense(m, seed, soda_on):
    random.seed(seed)     # match_captions' random strings for unmatched predictions
    c = _dvc_corpus(seed)
    return m.soda.evaluate_dense_captions(c["ps"], c["gs"], c["pc"], c["gc"], c["sp"], c["keys"],
                                          soda=soda_on)


SODA = {
    "iou": lambda m: [m.soda.iou(sorted(rng(s).random(2) * 10), sorted(rng(s + 1).random(2) * 10))
                      for s in range(10)],
    "chased_dp_assignment": lambda m: [m.soda.chased_dp_assignment(rng(s).random((a, b)))
                                       for s, a, b in ((0, 2, 5), (1, 6, 3), (2, 7, 7), (3, 1, 4))],
    "evaluate_detections": lambda m: m.soda.evaluate_detections(
        np.sort(rng(4).random((4, 2)) * 10, 1), np.sort(rng(5).random((5, 2)) * 10, 1),
        np.asarray([1, 1, 1, 2, 2])),
    "match_captions": lambda m: random.seed(0) or m.soda.match_captions(
        np.sort(rng(6).random((4, 2)) * 10, 1), np.sort(rng(7).random((3, 2)) * 10, 1),
        ["a b", "c d", "e f", "g h"], ["x", "y", "z"], rng=random.Random(0)),
    "evaluate_caption_scores": lambda m: m.soda.evaluate_caption_scores(
        {"0.3": _gts_res(8)[0], "0.5": {}}, {"0.3": _gts_res(8)[1], "0.5": {}},
        (0.3, 0.5), {"CIDER": m.captioning.Cider(), "METEOR": m.captioning.Meteor()}),
    "sodac": lambda m: m.soda.sodac(
        m.soda.evaluate_detections(np.sort(rng(9).random((3, 2)) * 10, 1),
                                   np.sort(rng(10).random((4, 2)) * 10, 1),
                                   np.asarray([1, 1, 2, 2]))[2],
        m.captioning.Meteor(), ["a man rides", "the dog runs", "red car"],
        ["a man rides a bike.", "dog runs fast.", "cooking pasta.", "the car turns left."],
        np.asarray([1, 1, 2, 2])),
    "parse_sent": lambda m: m.soda.parse_sent("A man, 2 dogs & the Red-car!"),
    "evaluate_dense_captions": lambda m: [_dense(m, s, so) for s, so in ((11, True), (12, False))],
    "evaluate_para": lambda m: m.soda.evaluate_para(
        ["a man rides his bike.", "the dog runs fast"],
        [["a man rides a bike down the hill."], ["dogs run."]]),
}


@pytest.mark.parametrize("case", list(SODA))
def test_soda_matches_jax(case, monkeypatch):
    monkeypatch.setenv("AHA_METEOR", "lite")
    same(*both(SODA[case]))


# -- the commands: grid-search, evaluate, highlight on JAX-format prediction files ---------


@pytest.fixture(scope="module")
def pred_files(tmp_path_factory):
    """Prediction and gold files in the formats of JAX's ``infer`` and the
    benchmarks: tvsum (a JSON array with true_frames_list, the annotation
    TSV), hisum (h5_identifier, an h5 gtscore file), charades grounding
    (JSONL, charades and QVHighlights golds), QVHighlights (JSONL golds) and
    dense captioning; a clip for the reel."""
    import h5py

    d = tmp_path_factory.mktemp("preds")
    r = rng(20)
    videos = {"vA": ("GA", 240), "vB": ("BK", 200), "vC": ("GA", 160), "vD": ("VT", 224),
              "vE": ("BK", 240), "vF": ("GA", 180)}
    write_tvsum_annotations(d / "anno.tsv", videos, seed=21)
    tv = []
    for i, (vid, (_, n)) in enumerate(videos.items()):
        T = n // 8
        dd = trace(30 + i, T)
        for e in dd:      # the driver's rounding: 3 places
            for k in list(e):
                e[k] = round(e[k], 3)
        tv.append({"video_uuid": vid, "model_response_list": [], "video_duration": T / 2,
                   "true_frames_list": list(range(0, n, 8)), "debug_data": dd})
    (d / "tvsum.json").write_text(json.dumps(tv, indent=4))
    hs = []
    with h5py.File(d / "gt.h5", "w") as hdf:
        for i in range(4):
            T = int(r.integers(20, 35))
            hdf.create_group(f"video_{i}").create_dataset(
                "gtscore", data=r.random(T + int(r.integers(-2, 3))))
            hs.append({"categories": ["Food"], "h5_identifier": f"video_{i}",
                       "video_uuid": f"yt{i}", "model_response_list": [], "video_duration": T,
                       "true_frames_list": list(range(T)), "debug_data": trace(40 + i, T)})
    (d / "hisum.json").write_text(json.dumps(hs))
    preds, golds = grounding_preds(41, n=5)
    (d / "grounding.jsonl").write_text("".join(json.dumps(p) + "\n" for p in preds))
    (d / "charades_gold.json").write_text(json.dumps(list(golds.values())))
    qgold = [{"question_id": p["question_id"], "qid": p["question_id"], "duration": 20,
              "relevant_windows": [[2.0, 8.0]], "relevant_clip_ids": [1, 2, 3, 4, 5],
              "answer": {"relevant_clip_ids": [1, 2, 3, 4, 5],
                         "saliency_scores": r.integers(0, 5, (5, 3)).tolist()},
              "saliency_scores": r.integers(0, 5, (5, 3)).tolist()} for p in preds]
    (d / "qvh_gold.json").write_text(json.dumps(qgold))
    (d / "qvh_gold.jsonl").write_text("".join(json.dumps(g) + "\n" for g in qgold[1:]))
    dvc_gold = {"annotations": [
        {"image_id": "x/vid1", "segments": [[0, 5], [5, 10]],
         "pure_cap": "a man cooks pasta. he serves the dish"},
        {"image_id": "vid2", "segments": [[1, 4], [4, 9], [9, 20]],
         "pure_cap": "the dog runs. a red car turns left. the man rides his bike"}]}
    dvc_pred = {"vid1": [{"timestamp": [0, 5], "caption": "a man cooks pasta."},
                         {"timestamp": [6, 9], "caption": "he serves food."}],
                "vid2": [{"timestamp": [2, 8], "caption": "a dog runs fast"}]}
    (d / "dvc_gold.json").write_text(json.dumps(dvc_gold))
    (d / "dvc_pred.json").write_text(json.dumps(dvc_pred))
    (d / "params.json").write_text(json.dumps({
        "tvsum": {"alpha": 0.5, "beta": 1.0, "epsilon": 1.5, "uncertainty_threshold": 0.08},
        "hisum": {"alpha": 1.0, "beta": 0.5, "epsilon": -2.5, "uncertainty_threshold": 0.1},
        "charades": {"alpha": 0.2, "beta": 1.5, "epsilon": 0.5, "uncertainty_threshold": 0.06}}))
    write_clip(d / "vA.mp4", n_frames=240, fps=30.0)
    return d


GRID_SEARCH_CMDS = {
    "tvsum": ["--test_dataset", "tvsum", "--pred_file", "tvsum.json", "--gold_file", "anno.tsv",
              "--seed", "0"],
    "tvsum_degraded": ["--test_dataset", "tvsum_degraded", "--pred_file", "tvsum.json",
                       "--gold_file", "anno.tsv", "--seed", "5"],
    "hisum": ["--test_dataset", "hisum", "--pred_file", "hisum.json", "--gold_file", "gt.h5"],
    "charades": ["--test_dataset", "charades", "--pred_file", "grounding.jsonl", "--gold_file",
                 "charades_gold.json"],
    "charades-qvh-golds": ["--test_dataset", "charades", "--pred_file", "grounding.jsonl",
                           "--gold_file", "qvh_gold.json"],
}


def _run_both(capsys, d, tmp_path, port_cmd, jax_cmd, argv, out_flag):
    """The two commands on the same files; (printed, written) of each."""
    outs = []
    for name, cmd in (("port", port_cmd), ("jax", jax_cmd)):
        out = tmp_path / f"{name}.json"
        if out_flag == "--save_path":      # merged into an existing file
            out.write_text(json.dumps({"youcook2": {"alpha": 1.0}}))
        cmd([str(d / a) if (d / a).exists() else a for a in argv] + [out_flag, str(out)])
        outs.append((capsys.readouterr().out, out.read_text() if out.exists() else None))
    return outs


@pytest.mark.parametrize("case", list(GRID_SEARCH_CMDS))
def test_cmd_grid_search_matches_jax(pred_files, tmp_path, capsys, case):
    """``grid-search`` over the default grid of 15,000 combinations: the same
    best parameters printed and merged into the params file."""
    (got, got_file), (ref, ref_file) = _run_both(capsys, pred_files, tmp_path,
                                                 tcli.cmd_grid_search, jcli.cmd_grid_search,
                                                 GRID_SEARCH_CMDS[case], "--save_path")
    assert got == ref and got_file == ref_file
    key = "charades" if case.startswith("charades") else case
    assert set(json.loads(got_file)) == {"youcook2", key}


EVALUATE_CMDS = {
    "tvsum": ["--func", "tvsum", "--pred_file", "tvsum.json", "--gold_file", "anno.tsv"],
    "hisum": ["--func", "hisum", "--pred_file", "hisum.json", "--gold_file", "gt.h5"],
    "grounding": ["--func", "grounding", "--pred_file", "grounding.jsonl", "--gold_file",
                  "charades_gold.json"],
    "grounding-qvh-golds": ["--func", "grounding", "--pred_file", "grounding.jsonl",
                            "--gold_file", "qvh_gold.json", "--params_key", "tvsum"],
    "qvh": ["--func", "qvh", "--pred_file", "grounding.jsonl", "--gold_file", "qvh_gold.json",
            "--relevance_threshold", "0.4", "--min_relevance_frames", "2"],
    "qvh-jsonl-golds": ["--func", "qvh", "--pred_file", "grounding.jsonl", "--gold_file",
                        "qvh_gold.jsonl"],
    "dense_captioning": ["--func", "dense_captioning", "--pred_file", "dvc_pred.json",
                         "--gold_file", "dvc_gold.json"],
}


@pytest.mark.parametrize("case", list(EVALUATE_CMDS))
def test_cmd_evaluate_matches_jax(pred_files, tmp_path, capsys, monkeypatch, case):
    """``evaluate`` with every function but magqa: the same metrics printed
    and written, on the params file given."""
    monkeypatch.setenv("AHA_METEOR", "lite")
    argv = EVALUATE_CMDS[case] + ["--params_file", "params.json"]
    (got, got_file), (ref, ref_file) = _run_both(capsys, pred_files, tmp_path,
                                                 tcli.cmd_evaluate, jcli.cmd_evaluate, argv,
                                                 "--output_file")
    assert got == ref and got_file == ref_file and json.loads(got_file)


def test_cmd_evaluate_falls_back_on_the_committed_params(pred_files, tmp_path, capsys,
                                                         monkeypatch):
    """No params file: both commands read the committed calibration
    (``configs/grid_search_params.default.json``), also from another
    working directory."""
    monkeypatch.chdir(tmp_path)
    argv = [str(pred_files / a) if a.endswith((".json", ".tsv")) else a
            for a in EVALUATE_CMDS["tvsum"]] + ["--params_file", str(tmp_path / "none.json")]
    tcli.cmd_evaluate(argv)
    got = capsys.readouterr()
    jcli.cmd_evaluate(argv)
    ref = capsys.readouterr()
    assert got.out == ref.out and "committed calibration" in got.err


def test_cmd_highlight_matches_jax(pred_files, tmp_path, capsys):
    """``highlight`` on one video of the tvsum predictions: the same selected
    frames and frames written, and reels with equal frames."""
    import cv2

    outs = []
    for name, cmd in (("port", tcli.cmd_highlight), ("jax", jcli.cmd_highlight)):
        reel = tmp_path / f"{name}.mp4"
        cmd(["--pred_file", str(pred_files / "tvsum.json"), "--video_uuid", "vA",
             "--video_path", str(pred_files / "vA.mp4"), "--output_filepath", str(reel),
             "--max_duration", "6", "--params_file", str(pred_files / "params.json"),
             "--source_fps", "30"])
        outs.append(capsys.readouterr().out)
        cap = cv2.VideoCapture(str(reel))
        frames = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            frames.append(f)
        outs.append(np.stack(frames))
    assert outs[0] == outs[2]
    res = json.loads(outs[0])
    assert len(res["selected"]) == 6 and res["frames_written"] == outs[1].shape[0] > 0
    np.testing.assert_array_equal(outs[1], outs[3])


def test_cmd_evaluate_magqa_and_refusals(pred_files, capsys):
    """magqa without a judge prints JAX's message and writes nothing (the
    judge itself: tests/test_torch_judge_cli.py); ``visualize --func
    tvsum_sota`` without a metrics file and ``demo`` without a video are
    refused by their flags as JAX's are (argparse, exit 2)."""
    argv = ["--func", "magqa", "--pred_file", str(pred_files / "grounding.jsonl"),
            "--gold_file", str(pred_files / "charades_gold.json")]
    tcli.cmd_evaluate(argv)
    got = capsys.readouterr().out
    jcli.cmd_evaluate(argv)
    assert got == capsys.readouterr().out and "--judge_ckpt" in got
    for port, jax_, bad in ((tcli.cmd_visualize, jcli.cmd_visualize, ["--func", "tvsum_sota"]),
                            (tinfer.cmd_demo, jinfer.cmd_demo, ["--query", "y"])):
        errs = []
        for cmd in (port, jax_):
            with pytest.raises(SystemExit) as e:
                cmd(bad)
            errs.append((e.value.code, capsys.readouterr().err.splitlines()[-1]))
        assert errs[0] == errs[1] and errs[0][0] == 2


# -- the offline baseline ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def offline_sessions():
    """(JAX session, port session), each built by its own command line from
    the same flags: JAX's synthetic tiny int8 tree, which the port draws bit
    for bit, and generation at width 1 (the default speculative width gives
    the same tokens; JAX compiles the sequential loop in half the time)."""
    import argparse

    from aha_tpu.cli._session import _add_infer_flags as jflags
    from aha_tpu.cli._session import _build_session as jbuild

    from aha_tpu_torch.cli._session import _add_infer_flags as tflags
    from aha_tpu_torch.cli._session import _build_session as tbuild

    argv = ["--test_dataset", "youcook2", "--input_dir", ".", "--output_fname", "unused",
            "--grounding_mode", "--model_preset", "tiny", "--synthetic_weights", "--int8",
            "--max_new_tokens", "12", "--spec_decode_tokens", "1"]

    def parse(add, more=()):
        p = argparse.ArgumentParser()
        add(p)
        return p.parse_args(argv + list(more))

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield jbuild(parse(jflags)), tbuild(parse(tflags, ["--device", "cpu"]))
    torch.set_num_threads(n)


def test_run_offline_baseline_matches_jax(offline_sessions, tmp_path, monkeypatch):
    """``run_offline_baseline`` (``offline_generate``: the system prompt, the
    whole video, the question, one greedy answer) over a missing video and
    two clips: the same lines, texts equal (JAX held to its cv2 decoder)."""
    from aha_tpu import native
    from aha_tpu.drivers import benchmarks as jbenchmarks

    from aha_tpu_torch.drivers import benchmarks

    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too
    for i, name in enumerate(("vidA", "vidB")):
        write_clip(tmp_path / f"{name}.mp4", n_frames=40, seed=i)
    (tmp_path / "qa.json").write_text(json.dumps([
        {"question_id": "b1", "video": "vidA.mp4",
         "conversation": [{"role": "user", "content": "what happens?", "time": 0}]},
        {"question_id": "b2", "video": "missing.mp4",
         "conversation": [{"role": "user", "content": "what?", "time": 0}]},
        {"question_id": "b3", "video": "vidB.mp4",
         "conversation": [{"role": "user", "content": "and here?", "time": 1}]}]))
    jsess, tsess = offline_sessions
    kw = dict(test_fname=str(tmp_path / "qa.json"), input_dir=str(tmp_path), frame_fps=2.0,
              max_num_frames=10)
    got = benchmarks.run_offline_baseline(tsess, output_fname=str(tmp_path / "port.jsonl"), **kw)
    ref = jbenchmarks.run_offline_baseline(jsess, output_fname=str(tmp_path / "jax.jsonl"), **kw)
    assert got == ref and [x["question_id"] for x in got] == ["b1", "b3"]
    assert all(x["model_response"][0] for x in got)
    assert (tmp_path / "port.jsonl").read_text() == (tmp_path / "jax.jsonl").read_text()
