"""Times the warp-specialised int8 / int4 product (``csrc/quant_matmul_ws.cu``)
at every token tile it is built for and 1, 2, 3, 4 and 6 K splits, at the
shapes the 7B paths hand it, beside the launch its plan chooses: the data
that the plan's estimate (``ops/kernels/int8_matmul.py``, the ``WS_*``
constants) is fitted to.

    python3 -m aha_tpu_torch.sweep_ws [--seed 0]

Prints the card's name and power limit, then one JSON object a shape:
``{"bits", "M", "K", "N", "chosen": "tile/splits", "times": {"tile/splits":
ms}}``, device time from a replayed CUDA graph, the weights cycled past L2.
Needs a CUDA card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys

import torch

# the decoder layer's four products, the projector's two, the int8 tower's three
LAYER = ((3584, 4608), (3584, 3584), (3584, 37888), (18944, 3584))
PROJECTOR = ((1024, 3584), (3584, 3584))
TOWER = ((1024, 1024), (1024, 4096), (4096, 1024))
LAYER_M = (171, 196, 220, 392, 926, 1024, 1568, 2048)
SPLITS = (1, 2, 3, 4, 6)


def graph_ms(fn, iters: int = 10, replays: int = 2) -> float:
    """Device time a call: ``iters`` calls captured in a CUDA graph, replayed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (iters * replays)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_ws: no CUDA device", file=sys.stderr)
        return 2
    from .ops.kernels import int4_matmul as k4
    from .ops.kernels import int8_matmul as k8

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True,
                         timeout=60).stdout.strip().splitlines()[0], flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    dev, bf = "cuda", torch.bfloat16
    shapes = [(M, K, N) for M in LAYER_M for K, N in LAYER]
    shapes += [(M, K, N) for M in (392, 1568) for K, N in PROJECTOR]
    for bits in (8, 4):
        tower = [(M, K, N) for M in (576, 18432) for K, N in TOWER] if bits == 8 else []
        for M, K, N in shapes + tower:
            copies = max(1, math.ceil(160e6 / (K * N * bits // 8)))   # past the 50 MB L2
            if bits == 8:
                ws = [torch.randint(-127, 128, (K, N), generator=gen, device=dev,
                                    dtype=torch.int8) for _ in range(copies)]
                sc = (torch.rand((1, N), generator=gen, device=dev) + 0.5) * (0.02 / 127)
                launch, tiles, unit = k8.launch_plan, k8.WS_TILES, 1
                chosen = k8.plan(M, K, N, bf16=True)
            else:
                ws = [torch.randint(0, 256, (K // 2, N), generator=gen, device=dev,
                                    dtype=torch.uint8) for _ in range(copies)]
                sc = ((torch.rand((K // 128, N), generator=gen, device=dev) + 0.5)
                      * (0.02 / 7)).to(bf)
                launch, tiles, unit = k4.launch_plan, k4.WS_TILES, 2
                chosen = k4.plan(M, K, N, 128, bf16=True)
            x = torch.randn((M, K), generator=gen, device=dev).to(bf)
            y = torch.empty((M, N), device=dev, dtype=bf)
            times = {}
            for tile in tiles:
                stages, smem = k8.ws_ring(tile, bits)
                for splits in SPLITS:
                    if splits > K // 64 // unit:
                        continue
                    pl = k8.Plan(k8.WGMMA_WS, splits, tile, -(-M // tile), stages, smem)
                    times[f"{tile}/{splits}"] = round(
                        graph_ms(lambda i: launch(x, None, ws[i % copies], sc, y, pl)), 5)
            print(json.dumps({"bits": bits, "M": M, "K": K, "N": N,
                              "chosen": f"{chosen.tile}/{chosen.splits}", "times": times}),
                  flush=True)
            del ws
    return 0


if __name__ == "__main__":
    sys.exit(main())
