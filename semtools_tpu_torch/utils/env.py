"""Environment-variable parsing shared across modules (a copy of
``semtools_tpu/utils/env.py``)."""

from __future__ import annotations

import os


def env_int(name: str, default: int) -> int:
    """Integer env var with a default; malformed values fall back."""
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default
