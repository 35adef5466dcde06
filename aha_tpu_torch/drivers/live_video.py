"""The live-video demo: stream a long video, detect highlight ticks, plot
the score trace and render a stitched frame + plot MP4.

The port's copy of ``aha_tpu/drivers/live_video.py``: ``load_tick_table`` /
``spans_to_ticks`` (hand-labelled ground truth), ``infer_on_live_video`` (the
scoring pass on ``StreamSession.score_video``, with the opt-in motion skip),
``plot_scores`` (matplotlib, imported where it is used), ``render_demo_video``
(cv2 only) and the ARL-SCOUT dialogue tagger ``tag_important_segments`` /
``segments_to_gt_ticks``. Numpy on the host around the session; the session
runs on its own device.

Tick-table JSON schema: {"<name>": {"spans": [[start, end, label]...],
"label": str}}, the (start, end, label) intervals of the reference's
hand-labelled tables; a legacy {"ticks": [seconds...]} list is read as
zero-length spans.
"""

from __future__ import annotations

import json
import os

import numpy as np

from ..ops.signal import find_ticks
from ..streaming.session import StreamSession
from .benchmarks import round_numbers


def load_tick_table(path: str, name: str) -> list[tuple[float, float, str]]:
    """Return the hand-labeled GT as (start, end, label) spans."""
    with open(path) as f:
        entry = json.load(f)[name]
    if "spans" in entry:
        return [(float(s), float(e), str(lbl)) for s, e, lbl in entry["spans"]]
    # legacy flat-float schema: zero-length unlabeled spans
    return [(float(t), float(t), "") for t in entry["ticks"]]


def spans_to_ticks(spans) -> list[float]:
    """Flatten GT spans to representative tick times (span starts — the
    reference's gt_tics list, infer_live_video.py:293-295)."""
    return [float(s[0]) if isinstance(s, (tuple, list)) else float(s)
            for s in spans]


def infer_on_live_video(
    session: StreamSession,
    video_frames: np.ndarray,
    query: str,
    fps: float,
    *,
    output_dir: str | None = None,
    gt_ticks: list[float] | None = None,
    score_key: str = "relevance_score",
    monitor=None,
    motion_skip_threshold: float | None = None,
    motion_max_skip: int = 8,
) -> dict:
    """Score the stream, detect ticks, optionally write plot + JSON.

    motion_skip_threshold (opt-in, beyond-reference): frames whose mean
    pixel change since the last scored frame stays under the threshold
    are not scored — the previous frame's scores are HELD on the uniform
    time grid (savgol/find_ticks semantics unchanged) and the skipped
    frames never enter the KV (the same semantic class as decoding at a
    lower fps; see data/media.motion_mask). `frames_scored` in the
    result reports the achieved compression."""
    if monitor is not None:
        monitor.start()
    session.reset()
    session.set_fps(fps=fps)
    if motion_skip_threshold is not None:
        from ..data import media

        keep = media.motion_mask(video_frames, motion_skip_threshold,
                                 max_skip=motion_max_skip)
        kept_idx = np.flatnonzero(keep)
        debug_kept = session.score_video(video_frames[keep], query=query)
        debug, ki = [], -1
        for t in range(len(video_frames)):
            if ki + 1 < len(kept_idx) and kept_idx[ki + 1] == t:
                ki += 1
            d = dict(debug_kept[ki])      # held frames copy the last scored
            d["time"] = t / fps
            d["scored"] = bool(keep[t])
            debug.append(d)
        frames_scored = int(keep.sum())
    else:
        debug = session.score_video(video_frames, query=query)
        frames_scored = len(debug)
    scores = np.asarray([d[score_key] for d in debug])
    ticks = find_ticks(scores, fps)
    gt_spans = [
        (s, s, "") if not isinstance(s, (tuple, list)) else tuple(s)
        for s in (gt_ticks or [])
    ]
    result = {
        "debug_data": round_numbers(debug, 3),
        "ticks": [float(t) for t in ticks],
        "gt_ticks": spans_to_ticks(gt_spans),
        "gt_spans": [[float(s), float(e), str(lbl)] for s, e, lbl in gt_spans],
        "fps": fps,
        "query": query,
        "frames_scored": frames_scored,
    }
    if monitor is not None:
        monitor.stop()
        result["telemetry"] = monitor.report()
    if output_dir:
        os.makedirs(output_dir, exist_ok=True)
        with open(os.path.join(output_dir, "live_scores.json"), "w") as f:
            json.dump(result, f)
        plot_scores(
            scores, fps, ticks, gt_spans,
            os.path.join(output_dir, "live_scores.png"),
        )
    return result


def plot_scores(scores, fps, ticks, gt_ticks, out_path, *, title="per-frame scores"):
    """Score curve with predicted tick lines and GT span overlays
    (ref :287-347: axvspan per (start, end, label) entry, zero-length
    spans widened to 1 s and drawn darker)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = np.arange(len(scores)) / fps
    fig, ax = plt.subplots(figsize=(10, 3))
    ax.plot(times, scores, lw=1, label="score")
    for t in ticks:
        ax.axvline(t, color="tab:red", alpha=0.6, lw=1,
                   label="pred tick" if t == ticks[0] else None)
    gt_spans = [(s, s, "") if not isinstance(s, (tuple, list)) else tuple(s)
                for s in gt_ticks]
    for idx, (start, end, label) in enumerate(gt_spans):
        color = f"C{idx % 10}"
        alpha = 0.3
        if start == end:
            end, alpha = start + 1, 0.8
        ax.axvspan(start, end, color=color, alpha=alpha,
                   label="gt span" if idx == 0 else None)
        if label:
            ax.text(0.5 * (start + end), 0.02, str(label), rotation=90,
                    va="bottom", ha="center", fontsize=5, clip_on=True,
                    transform=ax.get_xaxis_transform())
    ax.set_xlabel("time (s)")
    ax.set_ylabel("score")
    ax.set_title(title)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


def render_demo_video(
    video_frames: np.ndarray,   # [T, H, W, 3] uint8 RGB
    scores: np.ndarray,         # [T]
    fps: float,
    out_path: str,
    *,
    ticks: list[float] | None = None,
    plot_height: int = 160,
):
    """Stitch each frame above a growing score plot into an MP4
    (ref infer_and_generate_video, :362-414). Pure cv2 — no per-frame
    matplotlib rendering, so it keeps up with hour-long streams."""
    import cv2

    T, H, W = video_frames.shape[:3]
    smax = float(scores.max()) or 1.0
    canvas_h = H + plot_height
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (W, canvas_h))
    xs = np.linspace(0, W - 1, T).astype(int)
    ys = (plot_height - 4 - (scores / smax * (plot_height - 12))).astype(int)
    tick_frames = {int(round(t * fps)) for t in (ticks or [])}
    for t in range(T):
        canvas = np.zeros((canvas_h, W, 3), np.uint8)
        canvas[:H] = video_frames[t][..., ::-1]  # RGB -> BGR
        plot = canvas[H:]
        plot[:] = 24
        for i in range(1, t + 1):
            cv2.line(plot, (xs[i - 1], ys[i - 1]), (xs[i], ys[i]), (80, 220, 80), 1)
        for tf in tick_frames:
            if tf <= t:
                cv2.line(plot, (xs[tf], 0), (xs[tf], plot_height - 1), (0, 0, 230), 1)
        cv2.line(plot, (xs[t], 0), (xs[t], plot_height - 1), (200, 200, 200), 1)
        writer.write(canvas)
    writer.release()
    return out_path


# ---------------------------------------------------------------------------
# ARL-SCOUT-style dialogue importance tagging (ref prepare_data.py:10-56)
# ---------------------------------------------------------------------------

IMPORTANCE_KEYWORDS = {
    # command/action verbs score high; acknowledgements low
    "go": 2.0, "move": 2.0, "turn": 2.0, "stop": 2.5, "take": 2.0,
    "photo": 2.5, "picture": 2.5, "scan": 2.0, "search": 2.0, "look": 1.5,
    "find": 2.0, "door": 1.5, "room": 1.5, "object": 1.5, "forward": 1.5,
    "left": 1.0, "right": 1.0, "ok": -1.0, "okay": -1.0, "yes": -0.5,
    "done": 0.5, "executing": 0.5,
}


def tag_important_segments(
    segments: list[dict],   # [{'start': s, 'end': s, 'text': str}]
    *,
    keywords: dict[str, float] | None = None,
    threshold: float = 2.0,
) -> list[dict]:
    """Keyword-scored dialogue importance; segments >= threshold are
    important. Returns segments with 'score' and 'important' fields."""
    keywords = keywords or IMPORTANCE_KEYWORDS
    out = []
    for seg in segments:
        words = seg["text"].lower().split()
        score = sum(keywords.get(w.strip(".,!?"), 0.0) for w in words)
        out.append({**seg, "score": score, "important": score >= threshold})
    return out


def segments_to_gt_ticks(segments: list[dict]) -> list[float]:
    return [0.5 * (s["start"] + s["end"]) for s in segments if s.get("important")]
