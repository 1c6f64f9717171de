"""``python -m dasmtl_torch <command>`` — the port's umbrella entry point.

Counterparts of ``dasmtl/cli.py:19-34`` (``train_main`` / ``test_main``)
and its ``main`` dispatcher (``:208-249``): every command dispatches to
the port's own entry point (``python -m dasmtl_torch.serve`` and the
others stay as they are).  ``--device`` is ``cuda`` by default and raises
without a card, naming ``--device cpu``.
"""

from __future__ import annotations

import importlib
import sys
from typing import Optional

_SUBCOMMANDS = {
    "train": "train a model",
    "test": "evaluate a checkpoint (--model_path)",
    "stream": "streaming inference: offline sweep, or 'stream serve' for "
              "live multi-fiber tracking",
    "export": "export a serving artifact (python -m dasmtl_torch.export)",
    "serve": "online inference server (python -m dasmtl_torch.serve)",
    "router": "replica router tier: scale-out serving + blue/green "
              "rollout (python -m dasmtl_torch.serve.router)",
    "doctor": "environment diagnostics",
    "obs": "telemetry: trace dump/join, exposition check, alert "
           "selftest, profiler capture+analyze",
    "sanitize": "run-time sanitizers: determinism cells, --self-test "
                "(python -m dasmtl_torch.sanitize)",
}

#: The module whose ``main(argv) -> int`` each tool command runs.
_TOOLS = {
    "export": "dasmtl_torch.export",
    "serve": "dasmtl_torch.serve.__main__",
    "router": "dasmtl_torch.serve.router",
    "doctor": "dasmtl_torch.utils.doctor",
    "obs": "dasmtl_torch.obs.__main__",
    "sanitize": "dasmtl_torch.analysis.sanitize.runner",
}


def _run(argv, is_test: bool):
    """The run's final ``ValidationResult``; ``None`` when the model family
    is not yet ported (reported on stderr)."""
    from dasmtl_torch.config import parse_test_args, parse_train_args
    from dasmtl_torch.main import main_process

    cfg = (parse_test_args if is_test else parse_train_args)(argv)
    try:
        return main_process(cfg, is_test=is_test)
    except NotImplementedError as exc:
        print(f"dasmtl_torch: {exc}", file=sys.stderr)
        return None


def train_main(argv=None) -> Optional[object]:
    return _run(list(sys.argv[1:] if argv is None else argv), is_test=False)


def test_main(argv=None) -> Optional[object]:
    return _run(list(sys.argv[1:] if argv is None else argv), is_test=True)


def stream_main(argv=None) -> int:
    """``python -m dasmtl_torch.stream``: ``serve`` first starts the live
    tier, anything else is the offline record sweep."""
    from dasmtl_torch.stream.__main__ import main as stream

    return stream(list(sys.argv[1:] if argv is None else argv))


def main(argv=None) -> int:
    """Dispatch a command to its entry point."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m dasmtl_torch <command> [args...]\n\n"
              "commands:")
        for name, help_text in _SUBCOMMANDS.items():
            print(f"  {name:<8} {help_text}")
        return 0 if argv else 2
    cmd = argv.pop(0)
    if cmd not in _SUBCOMMANDS:
        print(f"dasmtl_torch: unknown command {cmd!r} (choose from "
              f"{', '.join(_SUBCOMMANDS)})", file=sys.stderr)
        return 2
    if cmd == "stream":
        return stream_main(argv)
    if cmd in _TOOLS:
        result = importlib.import_module(_TOOLS[cmd]).main(argv)
        return 0 if result is None else int(result)
    result = train_main(argv) if cmd == "train" else test_main(argv)
    return 2 if result is None else 0
