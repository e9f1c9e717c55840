"""The port's ``parse`` command: the LlamaParse and local backends."""

from semtools_tpu_torch.parse.backend import LlamaParseBackend, ParseResult
from semtools_tpu_torch.parse.cache import CacheManager
from semtools_tpu_torch.parse.config import LlamaParseConfig, load_parse_config
from semtools_tpu_torch.parse.client import JobError, ParseClient
from semtools_tpu_torch.parse.local_backend import LocalParseBackend, LocalParseError

__all__ = [
    "LlamaParseBackend",
    "LocalParseBackend",
    "LocalParseError",
    "ParseResult",
    "CacheManager",
    "LlamaParseConfig",
    "load_parse_config",
    "ParseClient",
    "JobError",
]
