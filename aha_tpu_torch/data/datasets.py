"""Training datasets: DVC, MAGQA, grounding and HIHD conversations, the
dataset wrapper with video loading, and the mixture builder.

The port's own copy of ``aha_tpu/data/datasets.py`` (which reaches for no
JAX): each builder is a pure function ``annotations -> [{'conversation',
'load_range', 'video_uid'}]``; ``StreamDataset`` adds the video decode and
the corrupt-sample fallback (a random resample, at most ten in a row);
``build_mixture_from_config`` reads the reference-style JSON list of
per-dataset entries (class name, roots, fps, max frames). Python's
``random.Random`` draws the MAGQA waits, the grounding templates, the DVC
instructions and the fallback's resamples, as in JAX, so one seed gives the
same examples in both packages.
"""

from __future__ import annotations

import json
import math
import random

import numpy as np

from ..tokenization import StreamTokenizer
from . import media
from .conversations import Example, build_example

DVC_INSTRUCTIONS = [
    {"role": "user", "content": "Please concisely narrate the video in real time."},
    {"role": "user", "content": "Help me to illustrate my view in short."},
    {"role": "user", "content": "Please simply describe what do you see."},
    {"role": "user", "content": "Continuously answer what you observed with simple text."},
    {"role": "user", "content": "Do concise real-time narration."},
    {"role": "user", "content": "Hey assistant, do you know the current video content? Reply me concisely."},
    {"role": "user", "content": "Simply interpret the scene for me."},
    {"role": "user", "content": "What can you tell me about? Be concise."},
    {"role": "user", "content": "Use simple text to explain what is shown in front of me."},
    {"role": "user", "content": "What is the action now? Please response in short."},
]

GROUNDING_TEMPLATES = [
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


# ---------------------------------------------------------------------------
# Conversation builders (pure)
# ---------------------------------------------------------------------------


def build_dvc_annos(annos: dict, metadata: dict, frame_fps: float) -> list[dict]:
    """Dense video captioning: timed narrations -> stream/assistant pairs
    (ref dvc.py:26-68). `annos`: {video_uid: {ann_uid: [narration...]}}."""
    out = []
    for video_uid, per_ann in annos.items():
        if video_uid not in metadata:
            continue
        duration = metadata[video_uid]["duration"]
        for narrations in per_ann.values():
            if not narrations:
                continue
            start_time = media.ceil_time_by_fps(0, frame_fps, 0, duration)
            conversation: list[dict] = []
            last_time, last_text = start_time, None
            for narration in narrations:
                if last_time >= duration:
                    break
                text = narration["text"]
                learn = narration.get("learn", True)
                if text == last_text:
                    continue
                time = media.ceil_time_by_fps(narration["time"], frame_fps, 0, duration)
                if time == last_time:
                    if conversation:
                        conversation[-1]["content"] = text
                else:
                    num_frames = int((time - last_time) * frame_fps)
                    mid = float(np.mean([narration["timespan"][0], narration["timespan"][1]]))
                    response_start = media.ceil_time_by_fps(mid, frame_fps, 0, duration)
                    response_frame_num = int((time - response_start) * frame_fps) + 1
                    conversation.extend([
                        {"role": "stream", "num_frames": num_frames, "learn": True},
                        {"role": "assistant", "content": text, "learn": learn,
                         "response_frame_num": response_frame_num},
                    ])
                last_time, last_text = time, text
            if not conversation:
                continue
            out.append({
                "conversation": conversation,
                "load_range": range(int(start_time * frame_fps), int(last_time * frame_fps)),
                "video_uid": video_uid,
            })
    return out


def build_magqa_annos(annos: list, metadata: dict, frame_fps: float,
                      rng: random.Random | None = None) -> list[dict]:
    """Multi-answer grounded QA: interleaved user/stream/assistant with
    0-20 random waiting frames before the first user turn (ref magqa.py:15-73)."""
    rng = rng or random
    out = []
    for anno in annos:
        video_uid = anno["video_uid"]
        if video_uid not in metadata:
            continue
        duration = metadata[video_uid]["duration"]
        if not anno["conversation"]:
            continue
        first = anno["conversation"][0]
        role, time, content = first["role"], first["time"], first["content"]
        video_start_time = anno.get("video_start_time", 100000000)
        if not (role == "user" and 0 < time <= duration and content):
            continue

        fps_time = media.ceil_time_by_fps(time, frame_fps, 0, duration)
        waiting = rng.randint(
            int((fps_time - video_start_time) * frame_fps), int(fps_time * frame_fps)
        )
        waiting = max(0, min(20, waiting))
        conversation: list[dict] = []
        if waiting:
            conversation.append({"role": "stream", "num_frames": waiting,
                                 "learn": waiting - 1})
        conversation.append({"role": "user", "content": content, "time": time,
                             "fps_time": fps_time})
        start_fps_time = fps_time - waiting / frame_fps

        for message in anno["conversation"][1:]:
            role, content, time = message["role"], message["content"], message["time"]
            learn = message.get("learn", True)
            timespan = message.get("timespan")
            if time > duration:
                break
            fps_time = media.ceil_time_by_fps(time, frame_fps, conversation[-1]["fps_time"], duration)
            if fps_time > duration:
                break
            if role == "user":
                if fps_time > conversation[-1]["fps_time"]:
                    conversation.append({
                        "role": "stream",
                        "num_frames": int((fps_time - conversation[-1]["fps_time"]) * frame_fps),
                        "learn": True,
                    })
                conversation.append({"role": "user", "content": content, "time": time,
                                     "fps_time": fps_time})
            else:
                if fps_time > conversation[-1]["fps_time"]:
                    num_frames = int((fps_time - conversation[-1]["fps_time"]) * frame_fps)
                    conversation.append({"role": "stream", "num_frames": num_frames,
                                         "learn": True})
                    mid = float(np.mean([timespan[0], timespan[1]]))
                    response_start = media.ceil_time_by_fps(mid, frame_fps, 0, duration)
                    response_frame_num = int((time - response_start) * frame_fps) + 1
                    response_frame_num = min(response_frame_num, num_frames)
                    conversation.append({
                        "role": "assistant", "content": content, "time": time,
                        "fps_time": fps_time, "learn": learn,
                        "response_frame_num": response_frame_num,
                    })
        if not conversation:
            continue
        out.append({
            "conversation": conversation,
            "load_range": range(int(start_fps_time * frame_fps),
                                int(conversation[-1]["fps_time"] * frame_fps)),
            "video_uid": video_uid,
        })
    return out


def build_grounding_annos(annos: list, metadata: dict, frame_fps: float,
                          rng: random.Random | None = None) -> list[dict]:
    """Temporal grounding: one query + one big stream turn with related spans
    (ref grounding.py:30-56)."""
    rng = rng or random
    out = []
    for anno in annos:
        video_uid = anno["video_uid"]
        if video_uid not in metadata:
            continue
        duration = metadata[video_uid]["duration"]
        conversation: list[dict] = []
        current_frame = 0
        conversation.append({
            "role": "user",
            "content": rng.choice(GROUNDING_TEMPLATES) % anno["query"],
            "learn": False,
        })
        related_info = []
        for start_time, end_time in anno["timestamps"]:
            start_frame = math.floor(start_time * frame_fps)
            if start_frame > current_frame:
                related_info.append({"related": False, "num_frames": start_frame - current_frame})
            end_frame = math.floor(end_time * frame_fps)
            related_info.append({"related": True, "num_frames": end_frame - start_frame})
            current_frame = end_frame
        last_frame = math.floor(duration * frame_fps)
        if last_frame > current_frame:
            related_info.append({"related": False, "num_frames": last_frame - current_frame})
        conversation.append({"role": "stream", "num_frames": last_frame, "learn": True,
                             "related": related_info})
        out.append({
            "conversation": conversation,
            "load_range": range(0, last_frame),
            "video_uid": video_uid,
        })
    return out


def build_hihd_annos(annos: dict, metadata: dict, frame_fps: float) -> list[dict]:
    """HIHD: user query + one 1-frame learned stream turn per score
    (ref HIHD.py:25-53). `annos`: {youtube_id: {scores, query, video_uid}}."""
    out = []
    for _, info in annos.items():
        video_uid = info["video_uid"]
        if video_uid not in metadata or not metadata[video_uid].get("valid", True):
            continue
        duration = metadata[video_uid]["duration"]
        conversation: list[dict] = [{"role": "user", "content": info["query"], "learn": False}]
        for s in info["scores"]:
            conversation.append({"role": "stream", "num_frames": 1, "learn": True, "related": s})
        final_frame = math.floor(duration * frame_fps)
        if final_frame < len(conversation):
            conversation = conversation[: final_frame + 1]
        out.append({
            "conversation": conversation,
            "load_range": range(0, final_frame),
            "video_uid": video_uid,
        })
    return out


def load_hihd_csv(anno_file: str, video_root: str) -> tuple[dict, dict]:
    """HIHD metadata CSV -> (annotations, quality_dropout intervals)
    (ref HIHD.get_annos, HIHD.py:56-88)."""
    import os

    import pandas as pd

    df = pd.read_csv(anno_file)
    df = df[df["training_split"] == "train"]
    all_files = set(os.listdir(video_root)) if os.path.isdir(video_root) else set()
    annotations, dropout = {}, {}
    for _, row in df.iterrows():
        video_uid = row["youtube_id"] + ".mp4"
        dropout[video_uid] = json.loads(row["quality_dropout"])
        if video_uid in all_files:
            annotations[row["youtube_id"]] = {
                "scores": json.loads(row["scores"]),
                "query": row["query"],
                "duration": row["duration"],
                "video_uid": video_uid,
            }
    return annotations, dropout


# ---------------------------------------------------------------------------
# Dataset wrapper + mixture
# ---------------------------------------------------------------------------


class StreamDataset:
    """Host-side dataset: conversation annos + lazy video decode.

    kind: 'dvc' | 'magqa' | 'grounding' | 'hihd' controls which per-frame
    label families are learned (ref: each subclass disables one label head).
    """

    LABEL_USE = {
        "dvc": (True, False),
        "magqa": (True, False),
        "grounding": (False, True),
        "hihd": (False, True),
    }

    def __init__(
        self,
        kind: str,
        annos: list[dict],
        tokenizer: StreamTokenizer,
        *,
        metadata: dict | None = None,
        video_root: str | None = None,
        system_prompt: str = "This is a system prompt.",
        frame_fps: float = 2.0,
        frame_size: int = 384,
        max_num_frames: int = 128,
        skip_video: bool = False,
        frame_loader=None,
        dropout_intervals: dict | None = None,
        seed: int = 0,
    ):
        assert kind in self.LABEL_USE, kind
        self.kind = kind
        self.annos = annos
        self.tokenizer = tokenizer
        self.metadata = metadata or {}
        self.video_root = video_root
        self.system_prompt = system_prompt
        self.frame_fps = frame_fps
        self.frame_size = frame_size
        self.max_num_frames = max_num_frames
        self.skip_video = skip_video
        self.frame_loader = frame_loader  # (video_uid, range) -> [T,S,S,3]
        self.dropout_intervals = dropout_intervals or {}
        self.rng = random.Random(seed)

    def __len__(self) -> int:
        return len(self.annos)

    def _load_frames(self, video_uid: str, load_range: range) -> np.ndarray:
        if self.frame_loader is not None:
            return self.frame_loader(video_uid, load_range)
        meta = self.metadata[video_uid]
        frames, _ = media.decode_video(
            meta["path"],
            output_fps=self.frame_fps,
            output_size=self.frame_size,
            source_fps=meta.get("fps"),
            duration=meta.get("duration"),
            dropout_intervals=self.dropout_intervals.get(video_uid),
        )
        return frames[load_range.start : load_range.stop]

    def __getitem__(self, index: int, _tries: int = 0) -> Example:
        use_info, use_rel = self.LABEL_USE[self.kind]
        try:
            anno = self.annos[index]
            conversation = list(anno["conversation"])
            if self.kind == "dvc":
                conversation = [self.rng.choice(DVC_INSTRUCTIONS)] + conversation
            ex = build_example(
                conversation,
                self.tokenizer,
                system_prompt=self.system_prompt,
                max_num_frames=self.max_num_frames,
                load_range=anno.get("load_range"),
                use_informative=use_info,
                use_relevance=use_rel,
            )
            if not self.skip_video:
                frames = self._load_frames(anno["video_uid"], ex.load_range)
                assert len(frames) == ex.num_frames, (len(frames), ex.num_frames)
                ex.frames = frames
            ex.sample_idx = index
            return ex
        except Exception:
            # corrupt-sample fallback: substitute a random example
            # (ref dvc.py:77-87 — deliberate training-robustness behavior),
            # but bounded: an all-corrupt dataset must fail loudly, not
            # recurse forever
            if _tries >= 10:
                raise
            return self.__getitem__(self.rng.randrange(len(self)), _tries + 1)


class ConcatDataset:
    def __init__(self, datasets: list):
        self.datasets = datasets
        self.offsets = np.cumsum([len(d) for d in datasets])

    def __len__(self) -> int:
        return int(self.offsets[-1]) if len(self.datasets) else 0

    def __getitem__(self, index: int):
        ds_idx = int(np.searchsorted(self.offsets, index, side="right"))
        prev = 0 if ds_idx == 0 else int(self.offsets[ds_idx - 1])
        return self.datasets[ds_idx][index - prev]


_BUILDERS = {
    "dvc": build_dvc_annos,
    "magqa": build_magqa_annos,
    "grounding": build_grounding_annos,
    "hihd": build_hihd_annos,
}

# reference class names -> our kinds (configs/datasets/aha_config.json)
_REF_CLASS_MAP = {
    "DenseVideoCaptioningStreamDataset": "dvc",
    "MAGQAStreamDataset": "magqa",
    "GroundingStreamDataset": "grounding",
    "HIHD": "hihd",
}


def build_mixture_from_config(config_path: str, tokenizer: StreamTokenizer, **common) -> ConcatDataset:
    """Dataset mixture from a reference-style JSON config: a list of entries
    with dataset_cls/video_root/anno_file/metadata_path/frame_fps/max_num_frames
    (ref data/__init__.py:18-23 + configs/datasets/aha_config.json)."""
    with open(config_path) as f:
        entries = json.load(f)
    datasets = []
    for entry in entries:
        kind = _REF_CLASS_MAP.get(entry.get("dataset_cls", ""), entry.get("kind"))
        assert kind in _BUILDERS, f"unknown dataset entry {entry}"
        metadata = media.scan_metadata(entry["video_root"], entry["metadata_path"])
        frame_fps = entry.get("frame_fps", common.get("frame_fps", 2.0))
        dropout = None
        if kind == "hihd":
            raw, dropout = load_hihd_csv(entry["anno_file"], entry["video_root"])
        else:
            with open(entry["anno_file"]) as f:
                raw = json.load(f)
        annos = _BUILDERS[kind](raw, metadata, frame_fps)
        datasets.append(
            StreamDataset(
                kind, annos, tokenizer,
                metadata=metadata,
                video_root=entry["video_root"],
                frame_fps=frame_fps,
                max_num_frames=entry.get("max_num_frames", common.get("max_num_frames", 128)),
                system_prompt=common.get("system_prompt", "This is a system prompt."),
                frame_size=common.get("frame_size", 384),
                dropout_intervals=dropout,
            )
        )
    return ConcatDataset(datasets)
