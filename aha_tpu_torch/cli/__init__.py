"""Command line of the port: ``python -m aha_tpu_torch.cli <command> ...``.

Counterpart of ``aha_tpu/cli``, with its eight command names and their
flags: ``infer`` for every dataset (the benchmarks, streaming QA at one
stream or several, the live-video datasets; ``infer.py``, with session
construction and the flags in ``_session.py``), ``demo``, the live-video
demo (``infer.py``), ``serve``, the continuous-batching JSONL server
(``serve.py``), ``train``, fine-tuning from a dataset mixture
(``train.py``), and the chain on ``infer``'s predictions: ``grid-search``,
``evaluate`` (the local LLM judge included), ``highlight`` and
``visualize`` (``evaluate.py``). Each command that builds a model takes
``--device`` as well (the card unless it names the CPU).
"""

from __future__ import annotations

import sys

from .evaluate import cmd_evaluate, cmd_grid_search, cmd_highlight, cmd_visualize
from .infer import cmd_demo, cmd_infer
from .serve import cmd_serve
from .train import cmd_train

COMMANDS = {"infer": cmd_infer, "demo": cmd_demo, "grid-search": cmd_grid_search,
            "evaluate": cmd_evaluate, "highlight": cmd_highlight, "visualize": cmd_visualize,
            "serve": cmd_serve, "train": cmd_train}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m aha_tpu_torch.cli {" + ",".join(COMMANDS) + "} ...")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available: {', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    from ..parallel.mesh import RanksError

    try:
        COMMANDS[cmd](argv[1:])
    except (NotImplementedError, RanksError) as e:   # an option not ported; a mesh too big
        print(f"aha_tpu_torch: {e}", file=sys.stderr)
        return 2
    return 0
