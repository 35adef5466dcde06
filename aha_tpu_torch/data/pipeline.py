"""Host work ahead of the device: the port's copy of
``aha_tpu/data/pipeline.py``.

  * ``prefetch_iterable``: an iterable computed ahead by a daemon thread
    (the eval drivers' dataset loops);
  * ``batch_iterator``: seeded shuffled epochs -> collated batches, the
    examples decoded by a thread pool (cv2 releases the interpreter lock)
    and prefetched ahead of the train step; ``shard_across_hosts`` splits each
    epoch's order across the processes (truncated to the shortest share), as
    JAX's does, and does nothing at one process;
  * ``extract_features``: videos pre-encoded to [T, F, H] ``.npy`` embeds
    by an engine's ``encode_frames`` (the port's ``visual_embed``);
  * ``FeatureSource``: a dataset's frame loader over those files.
"""

from __future__ import annotations

import os
import queue
import random
import threading

import numpy as np

from .collator import collate

_DONE = object()


class _Raise:
    """Carries a producer's exception to the consumer (an item may itself be
    an exception object)."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch_iterable(it, depth: int = 2):
    """Yield ``it``'s items in order, computed up to ``depth`` ahead by a
    daemon thread: the drivers wrap their dataset loops with it so that the
    next video's decode (cv2 releases the interpreter lock) overlaps the
    device's scoring of this one. A producer's exception re-raises at the
    consumer."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def producer():
        try:
            for x in it:
                if stop.is_set():
                    return
                q.put(x)
            q.put(_DONE)
        except BaseException as e:            # re-raised on the consumer's side
            q.put(_Raise(e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            x = q.get()
            if x is _DONE:
                break
            if isinstance(x, _Raise):
                raise x.exc
            yield x
    finally:
        stop.set()
        while not q.empty():                   # unblock a producer waiting on a full queue
            q.get_nowait()


def batch_iterator(dataset, tokenizer, *, batch_size: int, v_placeholder_id: int,
                   frame_num_tokens: int, seed: int = 0, num_epochs: int | None = None,
                   prefetch: int = 2, num_workers: int = 2, shard_across_hosts: bool = True,
                   **collate_kw):
    """Collated batch dicts (numpy arrays), ``prefetch`` ahead of the
    consumer. Each epoch is a ``random.Random(seed)`` shuffle of the dataset's
    indices cut into full batches (the remainder dropped); the examples of a
    batch are fetched by a pool of ``num_workers`` threads. Endless unless
    ``num_epochs`` is given. ``shard_across_hosts`` with several processes: each
    takes every n-th index of the epoch's order (``utils.dist.shard_iterable``),
    all of them as many as the shortest share, so that every process yields as
    many batches and none waits in a collective the others never reach."""
    from ..utils import dist

    rng = random.Random(seed)

    def index_stream():
        epoch = 0
        while num_epochs is None or epoch < num_epochs:
            order = list(range(len(dataset)))
            rng.shuffle(order)
            if shard_across_hosts and dist.process_count() > 1:
                order = list(dist.shard_iterable(order))
                order = order[: len(dataset) // dist.process_count()]
            for i in range(0, len(order) - batch_size + 1, batch_size):
                yield order[i : i + batch_size]
            epoch += 1

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        from concurrent.futures import ThreadPoolExecutor

        try:
            with ThreadPoolExecutor(num_workers) as pool:
                for idxs in index_stream():
                    if stop.is_set():
                        return
                    examples = list(pool.map(dataset.__getitem__, idxs))
                    q.put(collate(examples, tokenizer, v_placeholder_id=v_placeholder_id,
                                  frame_num_tokens=frame_num_tokens, **collate_kw).asdict())
            q.put(_DONE)
        except BaseException as e:            # re-raised on the consumer's side
            q.put(_Raise(e))

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            batch = q.get()
            if batch is _DONE:
                break
            if isinstance(batch, _Raise):
                raise batch.exc
            yield batch
    finally:
        stop.set()
        while not q.empty():                   # unblock a producer waiting on a full queue
            q.get_nowait()


def extract_features(video_paths: list[str], engine, output_dir: str, *, output_fps: float,
                     output_size: int = 384, max_frames: int | None = None,
                     shard: bool = True) -> list[str]:
    """Each video's frames encoded by ``engine.encode_frames`` (``visual_embed``
    a vision batch at a time) and saved as f32 [T, F, H] ``<name>.npy`` under
    ``output_dir``; a file already there is kept. ``shard``: each process
    encodes every n-th video (``utils.dist.shard_iterable``). Returns the files
    written or found; a video with no frame writes none."""
    from ..utils import dist
    from . import media

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for path in (list(dist.shard_iterable(video_paths)) if shard else video_paths):
        name = os.path.splitext(os.path.basename(path))[0]
        out_path = os.path.join(output_dir, f"{name}.npy")
        if os.path.exists(out_path):
            written.append(out_path)
            continue
        frames, _ = media.decode_video(path, output_fps=output_fps, output_size=output_size,
                                       max_frames=max_frames)
        if frames.shape[0] == 0:
            continue
        embeds = engine.encode_frames(frames).float().cpu().numpy()
        np.save(out_path, embeds)
        written.append(out_path)
    return written


class FeatureSource:
    """A dataset's ``frame_loader`` over the ``.npy`` embeds of
    ``extract_features``: it returns embeds, not pixels."""

    def __init__(self, feature_dir: str):
        self.feature_dir = feature_dir

    def __call__(self, video_uid: str, load_range: range) -> np.ndarray:
        name = os.path.splitext(video_uid)[0]
        arr = np.load(os.path.join(self.feature_dir, f"{name}.npy"), mmap_mode="r")
        return np.asarray(arr[load_range.start : load_range.stop])
