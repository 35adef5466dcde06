"""``aha serve`` on the port: the continuous-batching JSONL server, the port's
copy of ``aha_tpu/cli/serve.py:12-217``."""

from __future__ import annotations

import argparse
import json
import os
import sys


def _add_serve_flags(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device of the server (default: the card; 'cpu' runs the "
                        "kernels' plain versions on the host)")
    p.add_argument("--model_preset", default="7b", choices=["7b", "tiny"])
    p.add_argument("--llm_pretrained", default=None)
    p.add_argument("--tokenizer_pretrained", default=None)
    p.add_argument("--lora_pretrained", default=None,
                   help="peft adapter-only checkpoint dir (see infer)")
    p.add_argument("--int8", action="store_true")
    p.add_argument("--int4", action="store_true")
    p.add_argument("--synthetic_weights", action="store_true",
                   help="JAX's seeded synthetic params built on the device in their final "
                        "form (see infer)")
    p.add_argument("--vision_int8", action="store_true",
                   help="also quantize the SigLIP tower and the projector (see infer)")
    p.add_argument("--w8a8", action="store_true",
                   help="serving mode: int8 weights, per-token int8 activations, an int8 "
                        "vision tower (see infer; fused width stays 4 at --batch > 1)")
    p.add_argument("--fused_score_frames", type=int, default=4,
                   help="frames verified per decoder weight stream on the scoring passes "
                        "(1 = one frame a pass)")
    p.add_argument("--input", default="-", help="requests JSONL (- = stdin)")
    p.add_argument("--output", default="-", help="results JSONL (- = stdout)")
    p.add_argument("--batch", type=int, default=8, help="concurrent slots")
    p.add_argument("--max_frames", type=int, default=400)
    p.add_argument("--frame_fps", type=float, default=2.0)
    p.add_argument("--decode_workers", type=int, default=2)
    p.add_argument("--emit_scores", action="store_true",
                   help="include the per-frame score traces (debug_data)")
    p.add_argument("--stats", action="store_true",
                   help="print the wall-clock phase split (admit / text / score / gen / "
                        "host) to stderr at exit; each phase ends with a device sync, and "
                        "generation runs after the serving step so that it is timed apart")
    p.add_argument("--stream_end_prob_threshold", type=float, default=None)
    p.add_argument("--threshold_z", type=float, default=None)
    p.add_argument("--first_n_frames_no_generate", type=int, default=0)
    p.add_argument("--running_list_length", type=int, default=20)
    p.add_argument("--response_min_interval_frames", type=int, default=None)
    p.add_argument("--stream_end_score_sum_threshold", type=float, default=None)
    p.add_argument("--remove_assistant_turns", action="store_true")
    p.add_argument("--score_heads", default="relevance_score,informative_score")
    p.add_argument("--repetition_penalty", type=float, default=None)
    p.add_argument("--max_new_tokens", type=int, default=200)
    p.add_argument("--kv_cache_policy", default="sink",
                   choices=["sink", "sliding", "static", "none"])
    p.add_argument("--kv_window", type=int, default=2048)
    p.add_argument("--num_sink_tokens", type=int, default=32)
    p.add_argument("--kv_cache_dtype", default="auto", choices=["auto", "int8"])
    p.add_argument("--kv_mask_mode", default="hf", choices=["hf", "strict"])
    p.add_argument("--spec_decode_tokens", type=int, default=4,
                   help="speculative decoding: tokens verified per decoder pass (1 = off); "
                        "the same tokens either way")
    p.add_argument("--spec_decode_tokens_max", type=int, default=8,
                   help="acceptance-adaptive ceiling of the speculative width")
    p.add_argument("--retire_defer", type=int, default=1,
                   help="return to the host once this many streams have ended (1 = refill "
                        "slots at once)")
    p.add_argument("--mesh_data", type=int, default=1,
                   help="shard the slot batch over this many ranks (torchrun --nproc_per_node)")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="tensor-parallel ranks (7 q / 1 kv head a rank at --mesh_model 4)")


def _agreed(ready: bool, mesh) -> bool:
    """True on every rank when ``ready`` holds on all of them (one rank alone:
    ``ready``)."""
    if mesh is None:
        return ready
    from ..utils.dist import agreed_flag

    return agreed_flag(int(ready), "min")


def cmd_serve(argv):
    """Continuous-batching JSONL server: requests in, results out.

    Each input line is one request: {"key": "id", "video": "/path.mp4",
    "conversation": [{"role": "user", "time": 0.0, "content": "..."}]}, and
    optionally its own trigger rule (``stream_end_prob_threshold``,
    ``stream_end_score_sum_threshold``, ``threshold_z``). Each output line,
    written the moment its stream ends (completion order): {"key",
    "responses"[, "debug_data" with --emit_scores]}, or {"key", "error"} for
    a request that could not be read or decoded. A thread pool decodes
    videos (cv2) ahead of admission, so decoding overlaps serving; ``--batch``
    slots run continuous batching (``streaming/multi.MultiStreamServer``)."""
    import queue as _queue
    import threading
    from concurrent.futures import ThreadPoolExecutor

    from ..data import media
    from ..streaming.multi import MultiStreamServer
    from ._session import _build_parts

    p = argparse.ArgumentParser("aha serve", description="continuous-batching JSONL serving")
    _add_serve_flags(p)
    args = p.parse_args(argv)
    args.grounding_mode = False
    mesh = None
    if args.mesh_data * args.mesh_model > 1:
        from ..parallel.mesh import make_mesh
        from ..utils.dist import maybe_init_distributed

        maybe_init_distributed(args.device)
        mesh = make_mesh(args.mesh_data, args.mesh_model)   # the world must be the mesh
    main_rank = mesh is None or mesh.rank == 0

    params, cfg, tokenizer, infer_cfg, kw = _build_parts(args)
    server = MultiStreamServer(params, cfg, tokenizer, infer_cfg, batch=args.batch,
                               max_frames=args.max_frames, device=args.device, mesh=mesh, **kw)
    res = cfg.frame_resolution

    class RequestError(Exception):
        def __init__(self, key, cause):
            super().__init__(str(cause))
            self.key = key

    def decode_request(line):
        try:
            req = json.loads(line)
        except Exception as e:
            raise RequestError(None, e)
        key = req.get("key", req.get("video"))
        try:
            frames, _ = media.decode_video(req["video"], output_fps=args.frame_fps,
                                           output_size=res, max_frames=args.max_frames)
            opts = {k: req[k] for k in ("stream_end_prob_threshold",
                                        "stream_end_score_sum_threshold", "threshold_z")
                    if k in req}
        except Exception as e:
            raise RequestError(key, e)
        return key, frames, req.get("conversation", []), opts

    src = sys.stdin if args.input == "-" else open(args.input)
    # every rank serves every request; rank 0 alone writes the results
    out = (open(os.devnull, "w") if not main_rank else
           sys.stdout if args.output == "-" else open(args.output, "w"))
    pool = ThreadPoolExecutor(max_workers=args.decode_workers)
    pending: _queue.Queue = _queue.Queue()
    # at most 2 x workers requests decoded ahead: a long backlog cannot fill the
    # host's memory with frames
    depth = threading.Semaphore(2 * args.decode_workers)
    DONE = object()

    def feed_pool():
        try:
            for line in src:
                line = line.strip()
                if line:
                    depth.acquire()
                    pending.put(pool.submit(decode_request, line))
        finally:
            pending.put(DONE)            # a failing reader ends the server, never hangs it

    feeder = threading.Thread(target=feed_pool, daemon=True)
    feeder.start()

    def requests():
        """Decoded requests in input order; None while the next one is still
        decoding (the server keeps serving its occupied slots)."""
        cur = None
        while True:
            if cur is None:
                try:
                    # on a mesh the ranks admit a request at the same pull: wait
                    # for the next future, then agree on whether it is decoded
                    cur = pending.get() if mesh is not None else pending.get_nowait()
                except _queue.Empty:
                    yield None
                    continue
            if not _agreed(cur is DONE or cur.done(), mesh):
                yield None
                continue
            if cur is DONE:
                return
            fut, cur = cur, None
            depth.release()
            try:
                item = fut.result()
            except Exception as e:       # the request fails, not the server
                out.write(json.dumps({"key": getattr(e, "key", None), "error": str(e)}) + "\n")
                out.flush()
                continue
            yield item

    def emit(key, result):
        rec = {"key": key, "responses": result["responses"]}
        if args.emit_scores:
            rec["debug_data"] = result["debug_data"]
        out.write(json.dumps(rec) + "\n")
        out.flush()

    stats: dict | None = {} if args.stats else None
    try:
        n = len(server.run_items(requests(), fps=args.frame_fps, on_result=emit, stats=stats))
    finally:
        pool.shutdown()
        if out is not sys.stdout:
            out.close()
        if src is not sys.stdin:
            src.close()
    if not main_rank:
        return
    print(f"served {n} streams", file=sys.stderr)
    if stats is not None:
        print("phase split: " + json.dumps(
            {k: (round(v, 3) if isinstance(v, float) else v) for k, v in sorted(stats.items())}),
            file=sys.stderr)
