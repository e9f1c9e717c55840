"""The port's ``ask`` command: the tool-calling agent over grep, search and read."""

from semtools_tpu_torch.ask.agent import ask_agent, ask_agent_with_stdin, run_ask
from semtools_tpu_torch.ask.config import ApiMode, AskConfig, load_ask_config

__all__ = [
    "ask_agent",
    "ask_agent_with_stdin",
    "run_ask",
    "AskConfig",
    "ApiMode",
    "load_ask_config",
]
