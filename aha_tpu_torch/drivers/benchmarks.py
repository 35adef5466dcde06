"""The benchmark drivers of ``infer``: the port's copy of
``aha_tpu/drivers/benchmarks.py``.

  * ``run_tvsum`` (tvsum / tvsum_degraded, with the title ablations and
    ``no_query``) and ``run_hisum`` write one JSON array of {video_uuid,
    model_response_list, video_duration, true_frames_list, debug_data}
    (hisum adds categories and h5_identifier);
  * ``run_streaming_qa`` (one stream) and ``run_streaming_qa_multi``
    (concurrent streams) write JSONL, one line per question in dataset
    order: {question_id, model_response_list, video_duration, debug_data};
  * ``run_offline_baseline`` writes JSONL of {question_id, model_response,
    question, video_duration}, one generated answer per question.

Scores are rounded as the reference rounds them (``round_numbers``). The
next video decodes on the host while the card scores the current one.
"""

from __future__ import annotations

import csv
import json
import os
import random

import numpy as np

from ..data import media
from ..data.pipeline import prefetch_iterable
from ..streaming.session import StreamSession
from .eval_dataset import StreamingVideoQADataset


QUERY_TEMPLATES = [
    "%s",
    "%s",
    "What segment of the video addresses the topic '%s'?",
    "At what timestamp can I find information about '%s' in the video?",
    "Can you highlight the section of the video that pertains to '%s'?",
    "Which moments in the video discuss '%s' in detail?",
    "Identify the parts that mention '%s'.",
    "Where in the video is '%s' demonstrated or explained?",
    "What parts are relevant to the concept of '%s'?",
    "Which clips in the video relate to the query '%s'?",
    "Can you point out the video segments that cover '%s'?",
    "What are the key timestamps in the video for the topic '%s'?",
]


def truncate_sig(x: float, sig: int = 3) -> float:
    if x == 0:
        return 0
    return float(f"{x:.{sig}g}")


def round_numbers(data, n: int = 3):
    """Floats to n decimals, or to n significant digits where |x| <= 10^-n,
    through lists and dicts."""
    if isinstance(data, list):
        return [round_numbers(d, n) for d in data]
    if isinstance(data, dict):
        return {k: round_numbers(v, n) for k, v in data.items()}
    if isinstance(data, float):
        return truncate_sig(data, n) if abs(data) <= 10 ** (-n) else round(data, n)
    return data


def load_tvsum_captions(caption_file: str) -> dict:
    """TVSum's info TSV (a header, then category, id, title, url, length) ->
    {video id: {"query": title}}."""
    captions = {}
    with open(caption_file, newline="") as f:
        reader = csv.reader(f, delimiter="\t")
        next(reader)
        for row in reader:
            _, vid_id, caption, _, _ = row[:5]
            captions[vid_id] = {"query": caption}
    return captions


def _score_only_pass(session: StreamSession, frames, fps: float, query: str):
    """Scores with no generation (``score_video``): (responses, debug)."""
    session.reset()
    session.set_fps(fps=fps)
    session.score_video(frames, query=query)
    return [], session.debug_data_list


def _full_pass(session: StreamSession, frames, fps: float, conversation):
    """``inference()`` over the video with the conversation's queries:
    (responses, debug)."""
    session.reset()
    session.set_fps(fps=fps)
    session.input_video_stream(frames)
    session.input_query_stream(conversation)
    responses = session.inference()
    return responses, session.debug_data_list


def run_tvsum(session: StreamSession, *, input_dir: str, caption_file: str,
              video_metadata_file: str, output_fname: str, frame_fps: float = 1.0,
              degraded: bool = False, dropout_types: tuple[str, ...] = ("color_banding",),
              title_ablation: str | None = None, title_table: str | None = None,
              no_query: bool = False, generation: bool = False,
              seed: int | None = None) -> list[dict]:
    """TVSum / TVSum-degraded: every video of the metadata scan that has a
    caption, scored with no generation (``score_video``; ``generation``:
    ``inference()`` with the query at t = 0) behind a query drawn from
    ``QUERY_TEMPLATES`` with its title (``title_ablation`` 'ambiguous' or
    'unrelated': that title from the ``title_table`` JSON; ``no_query``: an
    empty query). The draws come from ``random.Random(seed)``, or the global
    ``random`` when seed is None, per video in metadata order, the dropout
    types after the query. ``degraded``: the video decoded with dropout
    segments seeded by ``hash(video_uuid) % 2**31`` (Python salts str hashes
    per process, so the segments repeat only within one process).
    Returns the results, written to ``output_fname`` as a JSON array."""
    metadata = media.scan_metadata(input_dir, video_metadata_file)
    captions = load_tvsum_captions(caption_file)
    titles = {}
    if title_ablation:
        assert title_table, "title ablation requires --title_table JSON"
        with open(title_table) as f:
            titles = json.load(f)
    rng = random.Random(seed) if seed is not None else random

    def decoded():
        for video_name in metadata:
            video_uuid = os.path.splitext(os.path.basename(video_name))[0]
            if video_uuid not in captions:
                continue
            video_path = metadata[video_name]["path"]
            title = captions[video_uuid]["query"]
            if title_ablation:
                title = titles[video_uuid][f"{title_ablation}_title"]
            query = "" if no_query else rng.choice(QUERY_TEMPLATES) % title
            dropout = None
            if degraded:
                dur = metadata[video_name]["duration"]
                segs = media.generate_dropout_segments(dur, seed=hash(video_uuid) % 2**31)
                dropout = [(s, e, rng.choice(dropout_types)) for s, e, _ in segs]
            frames, true_frames = media.decode_video(
                video_path, output_fps=frame_fps, output_size=session.args.frame_resolution,
                source_fps=metadata[video_name].get("fps"),
                duration=metadata[video_name].get("duration"), dropout_intervals=dropout)
            if frames.shape[0] == 0:
                continue
            yield video_uuid, frames, true_frames, query

    results = []
    for video_uuid, frames, true_frames, query in prefetch_iterable(decoded()):
        if generation:
            conv = [{"role": "user", "content": query, "time": 0}]
            responses, debug = _full_pass(session, frames, frame_fps, conv)
        else:
            responses, debug = _score_only_pass(session, frames, frame_fps, query)
        results.append({"video_uuid": video_uuid, "model_response_list": responses,
                        "video_duration": frames.shape[0] / frame_fps,
                        "true_frames_list": true_frames, "debug_data": round_numbers(debug, 3)})
    with open(output_fname, "w") as f:
        json.dump(results, f, indent=4)
    return results


def run_hisum(session: StreamSession, *, input_dir: str, anno_file: str, h5_file: str,
              hisum_metadata: str, video_metadata_file: str, output_fname: str,
              frame_fps: float = 1.0, no_query: bool = False,
              seed: int | None = None) -> list[dict]:
    """Mr.HiSum: the ``test_keys`` of ``anno_file`` whose video is in the
    metadata CSV (video_id, title, labels, youtube_id, yt8m_file) and on
    disk as ``<youtube_id>.mp4``, scored with no generation behind a query
    drawn as ``run_tvsum`` draws it. ``h5_file`` (the gtscore file, read at
    evaluation) must open. A video that fails is printed and skipped.
    Returns the results, written to ``output_fname`` as a JSON array."""
    import ast

    import h5py

    with h5py.File(h5_file, "r"):
        pass
    metadata = media.scan_metadata(input_dir, video_metadata_file)
    with open(anno_file) as f:
        videos = json.load(f)["test_keys"]
    rng = random.Random(seed) if seed is not None else random

    video_info = {}
    with open(hisum_metadata, newline="", encoding="utf-8") as f:
        for row in csv.DictReader(f):
            try:
                categories = [c for c in ast.literal_eval(row["labels"]) if c]
            except (SyntaxError, ValueError):
                categories = []
            video_info[row["video_id"]] = {"caption": row["title"], "categories": categories,
                                           "youtube_id": row["youtube_id"]}

    def decoded():
        for video_id in videos:
            info = video_info.get(video_id)
            if info is None:
                continue
            fname = f"{info['youtube_id']}.mp4"
            if fname not in metadata:
                continue
            try:
                query = "" if no_query else rng.choice(QUERY_TEMPLATES) % info["caption"]
                frames, true_frames = media.decode_video(
                    metadata[fname]["path"], output_fps=frame_fps,
                    output_size=session.args.frame_resolution,
                    source_fps=metadata[fname].get("fps"),
                    duration=metadata[fname].get("duration"))
                if frames.shape[0] == 0:
                    continue
                yield video_id, info, fname, frames, true_frames, query
            except Exception as e:  # one bad video does not end the run
                print(f"Exception on video {fname}: {e}")

    results = []
    for video_id, info, fname, frames, true_frames, query in prefetch_iterable(decoded()):
        try:
            responses, debug = _score_only_pass(session, frames, frame_fps, query)
            results.append({"categories": info["categories"], "h5_identifier": video_id,
                            "video_uuid": info["youtube_id"], "model_response_list": responses,
                            "video_duration": frames.shape[0] / frame_fps,
                            "true_frames_list": true_frames,
                            "debug_data": round_numbers(debug, 3)})
        except Exception as e:  # one bad video does not end the run
            print(f"Exception on video {fname}: {e}")
    with open(output_fname, "w") as f:
        json.dump(results, f, indent=4)
    return results


def run_offline_baseline(session: StreamSession, *, test_fname: str, input_dir: str,
                         output_fname: str, frame_fps: float, max_num_frames: int,
                         start_idx: int = 0, end_idx: int | None = None) -> list[dict]:
    """The offline single-answer baseline: each question's whole video, then
    its first user turn, and one generated answer
    (``StreamSession.offline_generate``). Returns the results, written to
    ``output_fname`` as JSONL."""
    dataset = StreamingVideoQADataset(
        test_fname, input_dir, start_idx=start_idx, end_idx=end_idx, output_fps=frame_fps,
        output_resolution=session.args.frame_resolution, max_num_frames=max_num_frames,
        system_prompt=session.args.system_prompt)
    results = []
    with open(output_fname, "w") as f_out:
        for i in range(len(dataset)):
            question_id, frames, conversation, fps, duration = dataset[i]
            if question_id is None:
                continue
            question = next(t["content"] for t in conversation if t["role"] == "user")
            response = session.offline_generate(frames, question, fps=fps)
            res = {"question_id": question_id, "model_response": [response],
                   "question": question, "video_duration": duration}
            results.append(res)
            f_out.write(json.dumps(res) + "\n")
            if i % 10 == 0:
                f_out.flush()
    return results


def run_streaming_qa(session: StreamSession, *, test_fname: str, input_dir: str,
                     output_fname: str, frame_fps: float, max_num_frames: int,
                     grounding_mode: bool = False, start_idx: int = 0,
                     end_idx: int | None = None,
                     time_instruction_format: str | None = None) -> list[dict]:
    """youcook2 / magqa / charades / generic at one stream: each question's
    video through ``inference()`` (or, in grounding mode, ``score_video``
    with the first user turn as the query), written to ``output_fname`` as
    it completes. Returns the results."""
    dataset = StreamingVideoQADataset(
        test_fname, input_dir, start_idx=start_idx, end_idx=end_idx, output_fps=frame_fps,
        output_resolution=session.args.frame_resolution, max_num_frames=max_num_frames,
        time_instruction_format=time_instruction_format,
        system_prompt=session.args.system_prompt)
    results = []
    items = prefetch_iterable((dataset[i] for i in range(len(dataset))), depth=2)
    with open(output_fname, "w") as f_out:
        for i, (question_id, frames, conversation, fps, duration) in enumerate(items):
            if question_id is None:
                continue
            if grounding_mode:
                query = next((t["content"] for t in conversation if t["role"] == "user"), "")
                _, debug = _score_only_pass(session, frames, fps, query)
                responses = [{"time": t.get("time", 0), "content": t["content"], "role": "user"}
                             for t in conversation if t["role"] == "user"]
            else:
                user_turns = [t for t in conversation if t["role"] == "user"]
                responses, debug = _full_pass(session, frames, fps, user_turns)
            res = {"question_id": question_id, "model_response_list": responses,
                   "video_duration": duration, "debug_data": round_numbers(debug, 3)}
            results.append(res)
            f_out.write(json.dumps(res) + "\n")
            if i % 5 == 0:
                f_out.flush()
    return results


def run_streaming_qa_multi(session: StreamSession, *, batch: int, test_fname: str,
                           input_dir: str, output_fname: str, frame_fps: float,
                           max_num_frames: int, grounding_mode: bool = False,
                           start_idx: int = 0, end_idx: int | None = None,
                           time_instruction_format: str | None = None) -> list[dict]:
    """``run_streaming_qa`` over ``batch`` concurrent streams in one batched
    engine (``infer --concurrent_streams N``), on ``session``'s weights,
    device and settings. The lines have the solo driver's format and, per
    stream, its content, in dataset order. Grounding mode scores fixed
    groups of ``batch`` videos in lockstep (``MultiStreamScorer``, the last
    group padded with empty streams); generation mode runs continuous
    batching (``MultiStreamServer``): a slot is refilled the moment its
    stream ends. Needs a fixed frame_fps."""
    from ..streaming.multi import MultiStreamScorer, MultiStreamServer

    if not isinstance(frame_fps, (int, float)) or frame_fps <= 0:
        raise ValueError("concurrent streams need a fixed positive frame_fps")
    eng = session.engine
    dataset = StreamingVideoQADataset(
        test_fname, input_dir, start_idx=start_idx, end_idx=end_idx, output_fps=frame_fps,
        output_resolution=session.args.frame_resolution, max_num_frames=max_num_frames,
        time_instruction_format=time_instruction_format,
        system_prompt=session.args.system_prompt)
    kw = dict(batch=batch, device=eng.device, backend=eng.backend, lora=eng.lora,
              lora_scale=eng.lora_scale)
    results: list[dict] = []
    if grounding_mode:
        scorer = MultiStreamScorer(eng.params, eng.cfg, session.tokenizer, session.args, **kw)
        S = session.args.frame_resolution

        def flush_group(group, f_out):
            n = len(group)
            if n == 0:
                return
            # empty pad streams cost nothing: the scorer's active mask blanks them
            items = group + [(None, np.zeros((0, S, S, 3), np.uint8), [], frame_fps, 0.0)
                             ] * (batch - n)
            # a real stream without a query scores behind "" as the solo driver's
            # does; a pad has no query chunk at all
            queries = [next((t["content"] for t in it[2] if t["role"] == "user"),
                            "" if it[0] is not None else None) for it in items]
            debugs = scorer.score_videos([it[1] for it in items], queries, fps=frame_fps)
            for it, dbg in zip(items[:n], debugs[:n]):
                res = {"question_id": it[0],
                       "model_response_list": [{"time": t.get("time", 0),
                                                "content": t["content"], "role": "user"}
                                               for t in it[2] if t["role"] == "user"],
                       "video_duration": it[4], "debug_data": round_numbers(dbg, 3)}
                results.append(res)
                f_out.write(json.dumps(res) + "\n")
            f_out.flush()

        group: list = []
        with open(output_fname, "w") as f_out:
            for i in range(len(dataset)):
                item = dataset[i]
                if item[0] is None:
                    continue
                group.append(item)
                if len(group) == batch:
                    flush_group(group, f_out)
                    group = []
            flush_group(group, f_out)
        return results

    server = MultiStreamServer(eng.params, eng.cfg, session.tokenizer, session.args,
                               max_frames=max_num_frames, **kw)
    meta: dict[int, tuple] = {}
    order: list[int] = []

    def gen_items():
        # the next videos decode on the host while the card serves the current ones
        raw = prefetch_iterable(((idx, dataset[idx]) for idx in range(len(dataset))), depth=2)
        for idx, (qid, frames, conversation, _fps, duration) in raw:
            if qid is None:
                continue
            meta[idx] = (qid, duration)
            order.append(idx)
            yield idx, frames, [t for t in conversation if t["role"] == "user"]

    done: dict[int, dict] = {}
    written = [0]
    with open(output_fname, "w") as f_out:

        def flush_ordered():
            while written[0] < len(order) and order[written[0]] in done:
                idx = order[written[0]]
                row = done.pop(idx)
                qid, duration = meta[idx]
                res = {"question_id": qid, "model_response_list": row["responses"],
                       "video_duration": duration,
                       "debug_data": round_numbers(row["debug_data"], 3)}
                results.append(res)
                f_out.write(json.dumps(res) + "\n")
                written[0] += 1
            f_out.flush()

        def on_result(idx, row):
            done[idx] = row
            flush_ordered()

        server.run_items(gen_items(), fps=frame_fps, on_result=on_result)
        flush_ordered()
    return results
