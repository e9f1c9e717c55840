"""Parse configuration.

Counterpart of ``semtools_tpu/parse/config.py``: the same file, keys,
defaults and priority.

Defaults mirror the reference (src/parse/config.rs:20-40): 10 concurrent
jobs, 5 s poll interval, 3600 s job timeout, 10 retries with 1000 ms base
delay and 2.0x exponential backoff, tier ``cost_effective`` + version
``latest`` parse kwargs, API key from ``LLAMA_CLOUD_API_KEY``.

The unified config file is ``~/.semtools_config.json`` with optional
``parse`` / ``ask`` sections (src/config.rs:10-20); resolution priority is
CLI arg > config file > env var > builtin default.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

DEFAULT_BASE_URL = "https://api.cloud.llamaindex.ai"
DEFAULT_PARSE_TIER = "cost_effective"
DEFAULT_PARSE_VERSION = "latest"


@dataclass
class LlamaParseConfig:
    api_key: Optional[str] = None
    num_ongoing_requests: int = 10
    base_url: Optional[str] = DEFAULT_BASE_URL
    parse_kwargs: Dict[str, Any] = field(
        default_factory=lambda: {
            "version": DEFAULT_PARSE_VERSION,
            "tier": DEFAULT_PARSE_TIER,
        }
    )
    check_interval: float = 5.0
    max_timeout: float = 3600.0
    max_retries: int = 10
    retry_delay_ms: float = 1000.0
    backoff_multiplier: float = 2.0

    def __post_init__(self) -> None:
        if self.api_key is None:
            self.api_key = os.environ.get("LLAMA_CLOUD_API_KEY")


def default_config_path() -> str:
    return str(Path.home() / ".semtools_config.json")


def load_parse_config(config_path: Optional[str] = None) -> LlamaParseConfig:
    """Load the ``parse`` section of the unified config file."""
    path = config_path or default_config_path()
    if not Path(path).exists():
        return LlamaParseConfig()
    data = json.loads(Path(path).read_text())
    section = data.get("parse") or {}
    kwargs: Dict[str, Any] = {}
    for key in (
        "api_key",
        "num_ongoing_requests",
        "base_url",
        "parse_kwargs",
        "check_interval",
        "max_timeout",
        "max_retries",
        "retry_delay_ms",
        "backoff_multiplier",
    ):
        if key in section:
            kwargs[key] = section[key]
    return LlamaParseConfig(**kwargs)
