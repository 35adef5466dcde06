"""Host-side media: the cv2 decoder with letterboxing, the quality-dropout
corruption, the metadata scan and the fps time quantisers.

The port's own copy of ``aha_tpu/data/media.py`` (no JAX there, but the port
imports nothing of that package): ``round_time_by_fps`` /
``ceil_time_by_fps`` / ``floor_time_by_fps``, ``resize_and_pad_frame``,
``dropout_simulation`` / ``generate_dropout_segments``, the cv2 path of
``decode_video`` (with the corruption applied during the decode),
``motion_mask`` (the live-video demo's frame skip), ``load_frame_folder``,
``write_video``, ``reencode_video``, ``probe_video`` and ``scan_metadata``.
``decode_video`` takes the native libav decoder (``aha_tpu_torch/native``)
where it is built, as JAX's does, and cv2 otherwise and for the corruption
path. cv2 is imported where it is used, so importing this module needs no
cv2.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..ops.preprocess import letterbox_params


def round_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(round(time * fps) / fps, min_time), max_time)


def ceil_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(math.ceil(time * fps) / fps, min_time), max_time)


def floor_time_by_fps(time: float, fps: float, min_time: float, max_time: float) -> float:
    return min(max(math.floor(time * fps) / fps, min_time), max_time)


def resize_and_pad_frame(frame: np.ndarray, output_size: int, pad_color=(0, 0, 0)) -> np.ndarray:
    """Aspect-preserving letterbox of an [H, W, 3] frame to a square canvas
    (cv2's bilinear resize, then a constant border)."""
    import cv2

    h, w = frame.shape[:2]
    if h == output_size and w == output_size:
        return frame
    new_h, new_w, top, left = letterbox_params(h, w, output_size)
    resized = cv2.resize(frame, (new_w, new_h))
    return cv2.copyMakeBorder(resized, top=top, bottom=output_size - new_h - top, left=left,
                              right=output_size - new_w - left,
                              borderType=cv2.BORDER_CONSTANT, value=pad_color)


# -- quality-dropout corruption ---------------------------------------------------


def dropout_simulation(frame: np.ndarray, w: int, h: int, dropout_type: str = "quality",
                       rng: np.random.Generator | None = None) -> np.ndarray:
    """One of four degradations of a frame: "quality" (down to 64 x 64 and
    back, blurred), "block_noise" (32 x 32 noise blocks at a 0.1 chance
    each), "color_banding" (values floored to multiples of 64), "blackout"."""
    import cv2

    rng = rng or np.random.default_rng()
    if dropout_type == "quality":
        degraded = cv2.resize(frame, (64, 64), interpolation=cv2.INTER_LINEAR)
        frame = cv2.resize(degraded, (w, h), interpolation=cv2.INTER_NEAREST)
        frame = cv2.GaussianBlur(frame, (5, 5), 0)
    elif dropout_type == "block_noise":
        bs = 32
        noise = rng.integers(0, 50, (bs, bs, 3), dtype=np.uint8)
        frame = frame.copy()
        for y in range(0, frame.shape[0], bs):
            for x in range(0, frame.shape[1], bs):
                if rng.random() < 0.1:
                    bh = min(bs, frame.shape[0] - y)
                    bw = min(bs, frame.shape[1] - x)
                    frame[y : y + bh, x : x + bw] = noise[:bh, :bw]
    elif dropout_type == "color_banding":
        frame = (frame // 64) * 64
    elif dropout_type == "blackout":
        frame = np.zeros_like(frame)
    return frame


def generate_dropout_segments(
    duration: float,
    *,
    coverage_range: tuple[float, float] = (0.05, 0.20),
    segment_range: tuple[float, float] = (2.0, 10.0),
    types: tuple[str, ...] = ("quality", "block_noise", "color_banding", "blackout"),
    seed: int | None = None,
    max_tries: int = 1000,
) -> list[tuple[float, float, str]]:
    """Seeded, sorted, non-overlapping corruption segments (start s, end s,
    type) covering a ``coverage_range`` share of the video."""
    rng = np.random.default_rng(seed)
    target = duration * rng.uniform(*coverage_range)
    segments: list[tuple[float, float, str]] = []
    covered = 0.0
    tries = 0
    while covered < target and tries < max_tries:
        tries += 1
        length = min(rng.uniform(*segment_range), target - covered)
        if length <= 0:
            break
        start = rng.uniform(0, max(duration - length, 0))
        end = start + length
        if any(not (end <= s or start >= e) for s, e, _ in segments):
            continue
        segments.append((start, end, str(rng.choice(types))))
        covered += length
    return sorted(segments)


# -- decoding -------------------------------------------------------------------


def decode_video(path: str, *, output_fps: float, output_size: int = 384,
                 source_fps: float | None = None, duration: float | None = None,
                 max_frames: int | None = None, dropout_intervals: list | None = None,
                 rng: np.random.Generator | None = None) -> tuple[np.ndarray, list[int]]:
    """Sequential cv2 decode resampled to ``output_fps``, letterboxed to
    ``output_size``: output frame i is the first source frame at or after
    i / output_fps, for floor(duration * output_fps) frames (at most
    ``max_frames``). ``dropout_intervals`` [(start s, end s, type)], sorted:
    a frame whose source time lies in one is corrupted by
    ``dropout_simulation`` (with ``rng``) before the letterbox. Returns
    (frames [T, S, S, 3] uint8 RGB, the source index of each output frame).
    Without ``dropout_intervals`` the native libav decoder runs where it is
    built (``aha_tpu_torch.native``: the same frame selection and letterbox);
    its failure falls back to cv2."""
    if dropout_intervals is None:
        try:
            from .. import native

            if native.available():
                return native.decode_video_native(path, output_fps=output_fps,
                                                  output_size=output_size,
                                                  max_frames=max_frames)
        except Exception:
            pass  # fall through to cv2
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    try:
        src_fps = source_fps or cap.get(cv2.CAP_PROP_FPS) or 30.0
        if duration is None:
            n_src = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            duration = n_src / src_fps if n_src > 0 else 0.0
        w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
        h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
        num_out = math.floor(duration * output_fps)
        if max_frames is not None:
            num_out = min(num_out, max_frames)
        pending = list(dropout_intervals) if dropout_intervals else []
        frames: list[np.ndarray] = []
        true_idx: list[int] = []
        cur_time, src_i = 0.0, 0
        while len(frames) < num_out:
            ret, frame = cap.read()
            if not ret:
                break
            if cur_time >= len(frames) / output_fps:
                while pending and cur_time > pending[0][1]:
                    pending.pop(0)
                if pending and pending[0][0] <= cur_time <= pending[0][1]:
                    frame = dropout_simulation(frame, w, h, pending[0][2], rng)
                frame = resize_and_pad_frame(frame, output_size)
                frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
                true_idx.append(src_i)
            cur_time += 1.0 / src_fps
            src_i += 1
    finally:
        cap.release()
    if not frames:
        return np.zeros((0, output_size, output_size, 3), np.uint8), []
    return np.stack(frames), true_idx


def motion_mask(frames: np.ndarray, threshold: float, *, max_skip: int = 8) -> np.ndarray:
    """[T, H, W, 3] uint8 -> bool [T]: the frames that carry new content. A
    frame is kept when its mean absolute pixel difference from the last kept
    frame exceeds ``threshold`` (a share of full scale: 0.02 is 5.1 grey
    levels), or when ``max_skip`` frames have been held since the last kept
    one (a slow pan still gets scored). Frame 0 is always kept. Skipped frames
    never enter the cache: the same kind of result as decoding at a lower
    rate."""
    T = frames.shape[0]
    keep = np.zeros(T, bool)
    if T == 0:
        return keep
    keep[0] = True
    anchor = frames[0].astype(np.int16)
    held = 0
    lim = float(threshold) * 255.0
    for t in range(1, T):
        held += 1
        if held >= max_skip:
            keep[t] = True
        else:
            keep[t] = np.abs(frames[t].astype(np.int16) - anchor).mean() > lim
        if keep[t]:
            anchor = frames[t].astype(np.int16)
            held = 0
    return keep


def load_frame_folder(frame_folder: str, *, output_size: int = 384, output_fps: float = 1.0,
                      start: int | None = None, end: int | None = None,
                      exts=(".jpg", ".jpeg", ".png")) -> tuple[np.ndarray, float, float]:
    """A directory of frame images, in name order, letterboxed: (frames [T, S,
    S, 3] RGB, fps, duration)."""
    import cv2

    names = sorted(n for n in os.listdir(frame_folder) if n.lower().endswith(exts))
    names = names[start:end]
    frames = []
    for name in names:
        img = cv2.imread(os.path.join(frame_folder, name))
        if img is None:
            continue
        img = resize_and_pad_frame(img, output_size)
        frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    arr = (np.stack(frames) if frames
           else np.zeros((0, output_size, output_size, 3), np.uint8))
    return arr, output_fps, arr.shape[0] / output_fps


def write_video(frames_rgb: np.ndarray, path: str, fps: float) -> int:
    """[T, H, W, 3] RGB uint8 -> an mp4v file. Returns the frames written."""
    import cv2

    T, H, W = frames_rgb.shape[:3]
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, (W, H))
    for t in range(T):
        writer.write(cv2.cvtColor(frames_rgb[t], cv2.COLOR_RGB2BGR))
    writer.release()
    return T


def reencode_video(src: str, dst: str, *, fps: float | None = None,
                   size: tuple[int, int] | None = None) -> int:
    """``src`` written again as an mp4v file at ``fps`` (the source's rate by
    default; frames kept at every source-rate / fps step) and ``size`` (W, H;
    the source's by default). Returns the frames written."""
    import cv2

    cap = cv2.VideoCapture(src)
    if not cap.isOpened():
        raise IOError(f"cannot open {src}")
    src_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    out_fps = fps or src_fps
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    out_size = size or (w, h)
    writer = cv2.VideoWriter(dst, cv2.VideoWriter_fourcc(*"mp4v"), out_fps, out_size)
    written, i, next_keep = 0, 0, 0.0
    step = src_fps / out_fps
    try:
        while True:
            ret, frame = cap.read()
            if not ret:
                break
            if i >= next_keep:
                if out_size != (w, h):
                    frame = cv2.resize(frame, out_size)
                writer.write(frame)
                written += 1
                next_keep += step
            i += 1
    finally:
        cap.release()
        writer.release()
    return written


def probe_video(path: str) -> dict:
    """One file's metadata: path, valid (a first frame decodes), fps, duration."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        return {"path": path, "valid": False, "fps": 0.0, "duration": 0.0}
    fps = cap.get(cv2.CAP_PROP_FPS) or 0.0
    n = cap.get(cv2.CAP_PROP_FRAME_COUNT) or 0.0
    ret, _ = cap.read()
    cap.release()
    return {"path": path, "valid": bool(ret), "fps": float(fps),
            "duration": float(n / fps) if fps else 0.0}


def scan_metadata(video_root: str, metadata_path: str, *, num_workers: int = 16,
                  exts=(".mp4", ".mkv", ".webm", ".avi", ".mov")) -> dict:
    """Metadata of every video under ``video_root`` by its relative path,
    probed by a thread pool (cv2 releases the interpreter lock) and cached as
    JSON at ``metadata_path``; an existing cache is read instead."""
    if os.path.exists(metadata_path):
        with open(metadata_path) as f:
            return json.load(f)
    files = []
    for root, _, names in os.walk(video_root):
        for name in names:
            if name.lower().endswith(exts):
                files.append(os.path.join(root, name))
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(num_workers) as pool:
        results = list(pool.map(probe_video, files))
    metadata = {os.path.relpath(r["path"], video_root): r for r in results}
    os.makedirs(os.path.dirname(metadata_path) or ".", exist_ok=True)
    with open(metadata_path, "w") as f:
        json.dump(metadata, f, indent=2)
    return metadata
