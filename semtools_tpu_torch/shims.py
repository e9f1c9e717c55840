"""Per-subcommand entry points of the port.

Twin of ``semtools_tpu/shims.py`` over the port's ``cli.main``.

The reference distributes five npm bin shims (``semtools``, ``parse``,
``search``, ``workspace``, ``ask``; cli/*.js) that exec the main binary
with the subcommand prepended. These console-script shims do the same.
"""

from __future__ import annotations

import sys

from semtools_tpu_torch.cli import main


def _shim(subcommand: str) -> int:
    return main([subcommand, *sys.argv[1:]])


def parse_main() -> int:
    return _shim("parse")


def search_main() -> int:
    return _shim("search")


def workspace_main() -> int:
    return _shim("workspace")


def ask_main() -> int:
    return _shim("ask")
