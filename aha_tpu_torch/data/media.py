"""Host-side media: the cv2 decoder with letterboxing and the fps time
quantisers.

The port's own trimmed copy of ``aha_tpu/data/media.py`` (no JAX there, but
the port imports nothing of that package): ``round_time_by_fps`` /
``ceil_time_by_fps`` / ``floor_time_by_fps``, ``resize_and_pad_frame`` and
the cv2 path of ``decode_video``. Not carried: the native libav decoder
(``aha_tpu/native``), the corruption simulation of the degraded datasets,
the motion mask and the metadata scan (ROADMAP.md, Queue 1 item 7). cv2 is
imported where it is used, so importing this module needs no cv2.
"""

from __future__ import annotations

import math

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


def decode_video(path: str, *, output_fps: float, output_size: int = 384,
                 source_fps: float | None = None, duration: float | None = None,
                 max_frames: int | None = None) -> tuple[np.ndarray, list[int]]:
    """Sequential cv2 decode resampled to ``output_fps``, letterboxed to
    ``output_size``: output frame i is the first source frame at or after
    i / output_fps, for floor(duration * output_fps) frames (at most
    ``max_frames``). Returns (frames [T, S, S, 3] uint8 RGB, the source
    index of each output frame)."""
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    try:
        src_fps = source_fps or cap.get(cv2.CAP_PROP_FPS) or 30.0
        if duration is None:
            n_src = cap.get(cv2.CAP_PROP_FRAME_COUNT)
            duration = n_src / src_fps if n_src > 0 else 0.0
        num_out = math.floor(duration * output_fps)
        if max_frames is not None:
            num_out = min(num_out, max_frames)
        frames: list[np.ndarray] = []
        true_idx: list[int] = []
        cur_time, src_i = 0.0, 0
        while len(frames) < num_out:
            ret, frame = cap.read()
            if not ret:
                break
            if cur_time >= len(frames) / output_fps:
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
