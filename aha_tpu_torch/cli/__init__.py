"""Command line of the port: ``python -m aha_tpu_torch.cli <command> ...``.

Counterpart of ``aha_tpu/cli``, with its command names and flags. Ported:
``infer`` for the benchmark and streaming-QA datasets, at one stream or
several (``infer.py``; session construction and the flags in
``_session.py``), ``serve``, the continuous-batching JSONL server
(``serve.py``), ``train``, fine-tuning from a dataset mixture
(``train.py``), and the chain on ``infer``'s predictions: ``grid-search``,
``evaluate`` and ``highlight`` (``evaluate.py``). ``demo`` and ``visualize``
exit 2 with a message that names their ROADMAP.md item.
"""

from __future__ import annotations

import sys

from .evaluate import cmd_evaluate, cmd_grid_search, cmd_highlight
from .infer import cmd_infer
from .serve import cmd_serve
from .train import cmd_train

# commands of the JAX package that are not ported yet -> their ROADMAP.md item
NOT_PORTED = {
    "demo": "Queue 1 item 7",
    "visualize": "Queue 1 item 11",
}


def _not_ported(name: str):
    def cmd(argv):
        raise NotImplementedError(f"aha {name} is not ported to aha_tpu_torch yet "
                                  f"(ROADMAP.md, {NOT_PORTED[name]})")
    return cmd


COMMANDS = {"infer": cmd_infer, "grid-search": cmd_grid_search, "evaluate": cmd_evaluate,
            "highlight": cmd_highlight, "serve": cmd_serve, "train": cmd_train,
            **{name: _not_ported(name) for name in NOT_PORTED}}


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m aha_tpu_torch.cli {" + ",".join(COMMANDS) + "} ...")
        return 0
    cmd = argv[0]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd}; available: {', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    try:
        COMMANDS[cmd](argv[1:])
    except NotImplementedError as e:          # a command or an option not ported yet
        print(f"aha_tpu_torch: {e}", file=sys.stderr)
        return 2
    return 0
