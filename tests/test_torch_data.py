"""The port's data pipeline against the JAX package's: tokenization with
offsets and learn ranges, ``build_example``, the four conversation builders,
``collate``, ``StreamDataset`` (cv2 frames, quality dropout, the corrupt-sample
fallback), the mixture config, ``batch_iterator``'s batches in order, the
media helpers and ``extract_features``.

The data code is host-side numpy and Python's ``random`` in both packages, so
every comparison is exact (arrays equal) except ``extract_features``, whose
embeds come from the two packages' vision towers on bridged tiny params
(atol 1e-5). JAX's decoder prefers its native libav build where there is one;
the port's does too, so both are held to their cv2 paths. Grounding
templates are drawn from the global ``random`` where no generator is passed
(as in JAX): it is seeded before each build.
"""

from __future__ import annotations

import json
import random
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aha_tpu import native
from aha_tpu import tokenization as jtokz
from aha_tpu.config import aha_tiny as jaha_tiny
from aha_tpu.data import collator as jcollator
from aha_tpu.data import conversations as jconv
from aha_tpu.data import datasets as jdatasets
from aha_tpu.data import media as jmedia
from aha_tpu.data import pipeline as jpipeline
from aha_tpu.models import aha as jaha

from aha_tpu_torch import bridge
from aha_tpu_torch import tokenization as tokz
from aha_tpu_torch.config import aha_tiny
from aha_tpu_torch.data import collator, conversations, datasets, media, pipeline
from aha_tpu_torch.models import aha as taha

cv2 = pytest.importorskip("cv2")

F = 3          # frame tokens in these tests' templates


@pytest.fixture(autouse=True)
def cv2_only(monkeypatch):
    monkeypatch.setattr(native, "available", lambda: False)
    monkeypatch.setenv("AHA_NATIVE_DECODER", "off")   # the port's too


def toks(vocab=512, frame_num_tokens=F):
    return (jtokz.build_stream_tokenizer(frame_num_tokens=frame_num_tokens, vocab_size=vocab),
            tokz.build_stream_tokenizer(frame_num_tokens=frame_num_tokens, vocab_size=vocab))


def conversation(rng):
    """A conversation with every role, learned and unlearned turns, frames."""
    conv = [{"role": "user", "content": "what happens?" * int(rng.integers(1, 3))}]
    for i in range(int(rng.integers(2, 5))):
        conv.append({"role": "stream", "num_frames": int(rng.integers(1, 4)), "learn": True,
                     "related": [{"related": bool(rng.integers(0, 2)), "num_frames": 1}] * 3})
        conv.append({"role": "assistant", "content": f"step {i} done" + "!" * i,
                     "learn": bool(rng.integers(0, 2)),
                     "response_frame_num": int(rng.integers(1, 3))})
    return conv


def write_clip(path, n_frames, fps=4.0, size=(48, 32), seed=0):
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    rng = np.random.default_rng(seed)
    for i in range(n_frames):
        frame = np.full((size[1], size[0], 3), (i * 13) % 255, np.uint8)
        frame[:8, :8] = rng.integers(0, 255, (8, 8, 3))
        out.write(frame)
    out.release()


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Four clips of unequal length, a grounding and a DVC annotation file,
    and a mixture config over both."""
    d = tmp_path_factory.mktemp("clips")
    vids = d / "videos"
    vids.mkdir()
    for i, n in enumerate((16, 12, 20, 9)):
        write_clip(vids / f"v{i}.mp4", n, seed=i)
    grounding = [{"video_uid": f"v{i}.mp4", "query": f"thing {i}",
                  "timestamps": [[0.5 + 0.5 * i, 2.0 + 0.25 * i]]} for i in range(4)]
    dvc = {f"v{i}.mp4": {"a": [{"text": f"event {i} begins", "time": 1.5,
                                "timespan": [0.5, 1.5]},
                               {"text": f"event {i} ends", "time": 2.5 + 0.25 * i,
                                "timespan": [1.5, 2.5]}]} for i in range(4)}
    (d / "g.json").write_text(json.dumps(grounding))
    (d / "d.json").write_text(json.dumps(dvc))
    mix = [{"dataset_cls": "GroundingStreamDataset", "video_root": str(vids),
            "anno_file": str(d / "g.json"), "metadata_path": str(d / "meta.json"),
            "frame_fps": 2.0, "max_num_frames": 6},
           {"dataset_cls": "DenseVideoCaptioningStreamDataset", "video_root": str(vids),
            "anno_file": str(d / "d.json"), "metadata_path": str(d / "meta.json"),
            "frame_fps": 2.0, "max_num_frames": 6}]
    (d / "mix.json").write_text(json.dumps(mix))
    return d


def _example_dict(ex):
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in vars(ex).items() if k != "frames"}


# -- tokenization --------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_offsets_and_learn_ranges_match_jax(seed):
    rng = np.random.default_rng(seed)
    jt, tt = toks()
    conv = [{"role": "system", "content": "sys"}] + conversation(rng)
    text = tt.apply_chat_template(conv, tokenize=False)
    assert text == jt.apply_chat_template(conv, tokenize=False)
    assert tt.encode_with_offsets(text) == jt.encode_with_offsets(text)
    assert tt.backend.encode(text) == jt.backend.encode(text)
    assert tt.get_learn_ranges(conv) == jt.get_learn_ranges(conv)
    assert tokz.transition_offsets(tt.template) == jtokz.transition_offsets(jt.template)
    assert tokz.stream_placeholder_len(5, tt.template) == jtokz.stream_placeholder_len(
        5, jt.template)


# -- examples and builders ------------------------------------------------------------


@pytest.mark.parametrize("max_frames,info,rel", [(None, True, True), (4, True, False),
                                                 (2, False, True), (7, True, True)])
def test_build_example_matches_jax(max_frames, info, rel):
    rng = np.random.default_rng(11)
    jt, tt = toks()
    for _ in range(3):
        conv = conversation(rng)
        n = sum(m["num_frames"] for m in conv if m["role"] == "stream")
        kw = dict(system_prompt="be brief", max_num_frames=max_frames, load_range=range(2, 2 + n),
                  use_informative=info, use_relevance=rel)
        got = conversations.build_example(conv, tt, **kw)
        ref = jconv.build_example(conv, jt, **kw)
        assert _example_dict(got) == _example_dict(ref)
    assert conversations.IGNORE == jconv.IGNORE


def _metadata(n=4):
    return {f"v{i}.mp4": {"duration": 6.0 + i, "valid": i != 3, "path": f"v{i}.mp4"}
            for i in range(n)}


def test_builders_match_jax():
    rng = np.random.default_rng(3)
    meta = _metadata()
    dvc = {f"v{i}.mp4": {f"a{j}": [
        {"text": f"t{i}{j}{k}", "time": float(t), "timespan": [float(t) - 1.0, float(t)],
         "learn": bool(k % 2)}
        for k, t in enumerate(np.sort(rng.uniform(0.5, 8.0, 4)))] for j in range(2)}
        for i in range(3)}
    dvc["gone.mp4"] = dvc["v0.mp4"]
    assert datasets.build_dvc_annos(dvc, meta, 2.0) == jdatasets.build_dvc_annos(dvc, meta, 2.0)
    magqa = [{"video_uid": f"v{i}.mp4", "video_start_time": 1.0, "conversation": [
        {"role": "user", "time": 1.0 + i, "content": "q?"},
        {"role": "assistant", "time": 3.0 + i, "content": "a.", "timespan": [2.0, 3.0]},
        {"role": "user", "time": 4.0 + i, "content": "and?"},
        {"role": "assistant", "time": 5.5, "content": "b.", "timespan": [4.0, 5.5]}]}
        for i in range(3)]
    assert (datasets.build_magqa_annos(magqa, meta, 2.0, rng=random.Random(5))
            == jdatasets.build_magqa_annos(magqa, meta, 2.0, rng=random.Random(5)))
    grounding = [{"video_uid": f"v{i}.mp4", "query": f"q{i}",
                  "timestamps": [[0.5, 2.0], [3.0, 4.5 + i]]} for i in range(4)]
    assert (datasets.build_grounding_annos(grounding, meta, 1.5, rng=random.Random(6))
            == jdatasets.build_grounding_annos(grounding, meta, 1.5, rng=random.Random(6)))
    hihd = {f"y{i}": {"video_uid": f"v{i}.mp4", "query": f"h{i}",
                      "scores": [float(x) for x in rng.random(9)]} for i in range(4)}
    assert datasets.build_hihd_annos(hihd, meta, 1.0) == jdatasets.build_hihd_annos(hihd, meta, 1.0)


def test_load_hihd_csv_matches_jax(tmp_path):
    pytest.importorskip("pandas")
    (tmp_path / "vids").mkdir()
    for i in (0, 2):
        (tmp_path / "vids" / f"y{i}.mp4").write_bytes(b"")
    rows = ["youtube_id,training_split,quality_dropout,scores,query,duration"]
    for i in range(3):
        rows.append(f'y{i},{"train" if i < 2 else "test"},"[[1.0, 2.0, ""quality""]]",'
                    f'"[0.1, 0.{i}]",query {i},{5 + i}')
    (tmp_path / "h.csv").write_text("\n".join(rows) + "\n")
    args = (str(tmp_path / "h.csv"), str(tmp_path / "vids"))
    assert datasets.load_hihd_csv(*args) == jdatasets.load_hihd_csv(*args)


# -- collation ------------------------------------------------------------------------


@pytest.mark.parametrize("frames_per_row,len_buckets", [((2, 5), None), ((3,), None),
                                                         ((1, 4, 2), (64, 128, 256, 512)),
                                                         ((6, 6), None)])
def test_collate_matches_jax(frames_per_row, len_buckets):
    rng = np.random.default_rng(len(frames_per_row))
    jt, tt = toks()
    examples = []
    for i, n in enumerate(frames_per_row):
        conv = [{"role": "user", "content": "x" * (3 + 7 * i)},
                {"role": "stream", "num_frames": n, "learn": True,
                 "related": [{"related": True, "num_frames": n}]},
                {"role": "assistant", "content": "done" * (i + 1), "learn": True}]
        ex = jconv.build_example(conv, jt, system_prompt="s")
        ex.frames = rng.integers(0, 255, (n, 8, 8, 3)).astype(np.uint8)
        ex.sample_idx = i
        examples.append(ex)
    kw = dict(v_placeholder_id=jt.v_placeholder_id, frame_num_tokens=F)
    if len_buckets:
        kw["len_buckets"] = len_buckets
    ref = jcollator.collate(examples, jt, **kw)
    got = collator.collate([conversations.Example(**vars(e)) for e in examples], tt, **kw)
    for k, v in vars(ref).items():
        if v is None:
            assert getattr(got, k) is None, k
        else:
            np.testing.assert_array_equal(getattr(got, k), v, err_msg=k)
    assert got.asdict().keys() == ref.asdict().keys()
    # buckets, left padding, and nothing learned on a padded position
    T = got.input_ids.shape[1]
    assert T in (len_buckets or collator.DEFAULT_LEN_BUCKETS)
    pad = ~got.attention_mask
    assert pad.any() and not pad[:, -1].any() and (np.diff(got.attention_mask.astype(int)) >= 0).all()
    assert (got.input_ids[pad] == tt.pad_token_id).all()
    for k in ("labels", "informative_labels", "relevance_labels"):
        assert (getattr(got, k)[pad] == conversations.IGNORE).all(), k
    assert got.frames.shape[0] in collator.DEFAULT_FRAME_BUCKETS
    assert got.num_frames == sum(frames_per_row)
    assert (got.frames[got.num_frames:] == 0).all()
    assert collator.bucket_length(257, (256, 512)) == 512
    with pytest.raises(ValueError, match="exceeds"):
        collator.bucket_length(513, (256, 512))


# -- media ----------------------------------------------------------------------------


def test_media_helpers_match_jax(tmp_path):
    for seed in (1, 7):
        assert (media.generate_dropout_segments(60.0, seed=seed)
                == jmedia.generate_dropout_segments(60.0, seed=seed))
    frame = np.random.default_rng(0).integers(0, 255, (40, 56, 3)).astype(np.uint8)
    for kind in ("quality", "block_noise", "color_banding", "blackout"):
        np.testing.assert_array_equal(
            media.dropout_simulation(frame, 56, 40, kind, np.random.default_rng(2)),
            jmedia.dropout_simulation(frame, 56, 40, kind, np.random.default_rng(2)))
    rgb = np.random.default_rng(1).integers(0, 255, (6, 32, 48, 3)).astype(np.uint8)
    assert media.write_video(rgb, str(tmp_path / "a.mp4"), 3.0) == 6
    jmedia.write_video(rgb, str(tmp_path / "b.mp4"), 3.0)
    assert (tmp_path / "a.mp4").read_bytes() == (tmp_path / "b.mp4").read_bytes()
    got, ref = media.probe_video(str(tmp_path / "a.mp4")), jmedia.probe_video(str(tmp_path / "a.mp4"))
    assert got == ref and got["valid"]
    assert media.probe_video(str(tmp_path / "none.mp4")) == jmedia.probe_video(
        str(tmp_path / "none.mp4"))
    folder = tmp_path / "frames"
    folder.mkdir()
    for i in range(4):
        cv2.imwrite(str(folder / f"{i:03d}.png"), rgb[i])
    (folder / "notes.txt").write_text("skip")
    for kw in ({}, {"start": 1, "end": 3, "output_fps": 2.0}):
        a, b = (m.load_frame_folder(str(folder), output_size=24, **kw) for m in (media, jmedia))
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1:] == b[1:]
    assert (media.scan_metadata(str(tmp_path), str(tmp_path / "m1.json"))
            == jmedia.scan_metadata(str(tmp_path), str(tmp_path / "m2.json")))
    # the cache is read back as written
    assert media.scan_metadata("/nonexistent", str(tmp_path / "m1.json"))["a.mp4"]["valid"]


@pytest.mark.parametrize("intervals", [[(0.5, 1.2, "quality"), (2.0, 3.0, "color_banding")],
                                       [(0.0, 0.6, "blackout"), (1.0, 1.5, "quality")]])
def test_decode_video_with_dropout_matches_jax(clips, intervals):
    path = str(clips / "videos" / "v0.mp4")
    got, idx = media.decode_video(path, output_fps=2.0, output_size=24,
                                  dropout_intervals=intervals)
    ref, ref_idx = jmedia.decode_video(path, output_fps=2.0, output_size=24,
                                       dropout_intervals=intervals)
    np.testing.assert_array_equal(got, ref)
    assert idx == ref_idx
    clean, _ = media.decode_video(path, output_fps=2.0, output_size=24)
    assert not np.array_equal(clean, got)


# -- datasets, the mixture, the batch iterator -----------------------------------------


def _dataset_pair(kind, annos, meta, vids, **kw):
    jt, tt = toks()
    common = dict(metadata=meta, video_root=str(vids), frame_fps=2.0, frame_size=24,
                  max_num_frames=6, **kw)
    return (jdatasets.StreamDataset(kind, annos, jt, **common),
            datasets.StreamDataset(kind, annos, tt, **common))


def test_stream_dataset_matches_jax(clips):
    vids = clips / "videos"
    meta = jmedia.scan_metadata(str(vids), str(clips / "meta.json"))
    raw = json.loads((clips / "d.json").read_text())
    annos = jdatasets.build_dvc_annos(raw, meta, 2.0)
    # a corrupt sample (a video that is not there) falls back to a random one
    annos = annos + [dict(annos[0], video_uid="gone.mp4")]
    meta = dict(meta, **{"gone.mp4": {"path": str(vids / "gone.mp4"), "duration": 4.0}})
    dropout = {"v1.mp4": [(0.2, 1.4, "quality")], "v2.mp4": [(1.0, 2.5, "color_banding")]}
    jd, td = _dataset_pair("dvc", annos, meta, vids, dropout_intervals=dropout, seed=4)
    assert len(td) == len(jd) == 5
    for i in (0, 1, 2, 4, 3, 4, 1):
        a, b = td[i], jd[i]
        assert _example_dict(a) == _example_dict(b)
        np.testing.assert_array_equal(a.frames, b.frames)
        assert a.frames.shape == (a.num_frames, 24, 24, 3)
    # the fallback is bounded: every sample corrupt raises after ten resamples
    bad = [dict(annos[0], video_uid="gone.mp4")] * 3
    for d in _dataset_pair("grounding", bad, meta, vids):
        with pytest.raises(Exception):
            d[0]


def test_mixture_and_batch_iterator_match_jax(clips):
    jt, tt = toks()
    random.seed(9)
    jmix = jdatasets.build_mixture_from_config(str(clips / "mix.json"), jt, frame_size=24)
    random.seed(9)
    tmix = datasets.build_mixture_from_config(str(clips / "mix.json"), tt, frame_size=24)
    assert len(tmix) == len(jmix) == 8
    assert [d.kind for d in tmix.datasets] == ["grounding", "dvc"]
    for dj, dt in zip(jmix.datasets, tmix.datasets):
        assert dt.annos == dj.annos and dt.max_num_frames == dj.max_num_frames == 6
    kw = dict(batch_size=3, v_placeholder_id=jt.v_placeholder_id, frame_num_tokens=F, seed=5,
              num_epochs=2, num_workers=1)
    got = list(pipeline.batch_iterator(tmix, tt, **kw, shard_across_hosts=False))
    ref = list(jpipeline.batch_iterator(jmix, jt, **kw, shard_across_hosts=False))
    assert len(got) == len(ref) == 4          # two full batches an epoch, the rest dropped
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in r:
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)
    # rows of unequal length: left padding in every batch
    assert all((~g["attention_mask"]).any() for g in got)


def test_batch_iterator_reraises_a_producer_error(clips):
    jt, tt = toks()
    bad = [{"conversation": [{"role": "user", "content": "q"}], "load_range": range(0, 2),
            "video_uid": "gone.mp4"}]
    ds = datasets.StreamDataset("grounding", bad, tt, metadata={"gone.mp4": {"path": "gone"}},
                                frame_size=24)
    it = pipeline.batch_iterator(ds, tt, batch_size=1, v_placeholder_id=tt.v_placeholder_id,
                                 frame_num_tokens=F)
    with pytest.raises(Exception):
        next(it)


def test_extract_features_matches_jax(clips, tmp_path):
    """Embeds of two clips through each package's tower and projector on the
    same (bridged) tiny params, atol 1e-5; ``FeatureSource`` reads them back."""
    jcfg = jaha_tiny()
    jparams = jaha.init_aha_params(jcfg, jax.random.PRNGKey(0))
    tparams = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    tcfg = aha_tiny()
    paths = [str(clips / "videos" / f"v{i}.mp4") for i in (0, 3)]
    jeng = types.SimpleNamespace(encode_frames=lambda f: jaha.visual_embed(
        jparams, jcfg, jnp.asarray(f)))
    teng = types.SimpleNamespace(encode_frames=lambda f: taha.visual_embed(
        tparams, tcfg, torch.as_tensor(f)))
    kw = dict(output_fps=2.0, output_size=tcfg.frame_resolution, max_frames=5)
    got = pipeline.extract_features(paths, teng, str(tmp_path / "t"), **kw)
    ref = jpipeline.extract_features(paths, jeng, str(tmp_path / "j"), shard=False, **kw)
    assert [p.split("/")[-1] for p in got] == [p.split("/")[-1] for p in ref] == ["v0.npy",
                                                                                 "v3.npy"]
    for g, r in zip(got, ref):
        a, b = np.load(g), np.load(r)
        assert a.shape == b.shape == (5 if "v0" in g else 4, tcfg.frame_num_tokens,
                                      tcfg.llm.hidden_size) and a.dtype == np.float32
        np.testing.assert_allclose(a, b, atol=1e-5)
    # a file already there is kept
    assert pipeline.extract_features(paths[:1], None, str(tmp_path / "t"), **kw) == got[:1]
    src, jsrc = pipeline.FeatureSource(str(tmp_path / "t")), jpipeline.FeatureSource(
        str(tmp_path / "t"))
    np.testing.assert_array_equal(src("v0.mp4", range(1, 4)), jsrc("v0.mp4", range(1, 4)))
