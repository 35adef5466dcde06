"""The streaming-QA evaluation dataset: ``StreamingVideoQADataset``, the
port's copy of ``aha_tpu/drivers/eval_dataset.py:21-107``. A JSON list of
{question_id, video, conversation}; each item is the video decoded at
``output_fps`` (or, at 'auto' or <= 0, at the rate that spreads
``max_num_frames`` over the whole video), the conversation behind a system
turn, with an optional timechat / vtimellm time instruction before the
first turn. A missing video or an unreadable sample is skipped (an item of
Nones), as the reference does."""

from __future__ import annotations

import json
import math
import os

from ..config import InferConfig
from ..data import media


class StreamingVideoQADataset:
    def __init__(self, data_file: str, video_base_folder: str, *, start_idx: int = 0,
                 end_idx: int | None = None, output_fps: float | str = 2,
                 output_resolution: int = 384, max_num_frames: int = 100,
                 time_instruction_format: str | None = None,
                 system_prompt: str = InferConfig.system_prompt):
        with open(data_file) as f:
            self.data = json.load(f)[start_idx:end_idx]
        self.video_base_folder = video_base_folder
        self.output_fps = output_fps
        self.output_resolution = output_resolution
        self.max_num_frames = max_num_frames
        self.system_prompt = system_prompt
        self.time_instruction_format = time_instruction_format

    def __len__(self) -> int:
        return len(self.data)

    def _load_video(self, path: str):
        import cv2

        cap = cv2.VideoCapture(path)
        try:
            input_fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
            duration = cap.get(cv2.CAP_PROP_FRAME_COUNT) / input_fps
        finally:
            cap.release()
        if isinstance(self.output_fps, str) or self.output_fps <= 0:
            fps = self.max_num_frames / duration
        else:
            fps = float(self.output_fps)
        frames, _ = media.decode_video(path, output_fps=fps, output_size=self.output_resolution,
                                       source_fps=input_fps, duration=duration,
                                       max_frames=self.max_num_frames)
        n = frames.shape[0]
        if self.time_instruction_format == "timechat":
            secs = ",".join(f"{i / fps:.2f}s" for i in range(math.ceil(duration * fps)))
            instr = (f"The video lasts for {duration:.2f} seconds, and {n} frames are"
                     f" uniformly sampled from it. These frames are located at {secs}."
                     "Please answer the following questions related to this video.")
            return frames, fps, duration, instr
        if self.time_instruction_format == "vtimellm":
            return frames, fps, duration, f"This is a video with {n} frames."
        return frames, fps, duration, None

    def __getitem__(self, idx: int):
        """(question_id, frames [T, S, S, 3] uint8, conversation, fps,
        duration), or five Nones for a sample that is skipped."""
        example = self.data[idx]
        try:
            conversation = list(example["conversation"])
            question_id = example["question_id"]
            path = os.path.join(self.video_base_folder, example["video"])
            for cand in (path, path[:-4] + ".mp4"):
                if os.path.exists(cand):
                    frames, fps, duration, instr = self._load_video(cand)
                    if instr is not None:
                        conversation[0] = dict(conversation[0])
                        conversation[0]["content"] = instr + "\n" + conversation[0]["content"]
                    conversation = [{"role": "system", "content": self.system_prompt},
                                    *conversation]
                    return question_id, frames, conversation, fps, duration
            print(f"Video {example['video']} does not exist, skipping")
        except (OSError, KeyError, ValueError, ZeroDivisionError) as e:
            print(f"error loading {example.get('question_id')}: {e}; skipped")
        return None, None, None, None, None
