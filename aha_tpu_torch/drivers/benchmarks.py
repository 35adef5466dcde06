"""The streaming-QA driver: ``run_streaming_qa`` and the two passes it
runs, the port's copy of ``aha_tpu/drivers/benchmarks.py:48-91, 290-344``.
Output: JSONL, one line per question, {question_id, model_response_list,
video_duration, debug_data} with the scores rounded as the reference rounds
them. The tvsum / hisum drivers and multi-stream serving are not ported
(ROADMAP.md, Queue 1 items 7 and 10)."""

from __future__ import annotations

import json

from ..data.pipeline import prefetch_iterable
from ..streaming.session import StreamSession
from .eval_dataset import StreamingVideoQADataset


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
