"""The ask agent: a tool-calling loop over grep/search/read.

Counterpart of ``semtools_tpu/ask/agent.py``. The embedder is the port's
``StaticModel`` on ``--device`` (default ``$SEMTOOLS_TORCH_DEVICE``, else
cuda), memoized per device, so an ``ask`` served by the daemon reuses its
resident model; the search tool's scans run on that device.

Loop structure mirrors the reference (src/ask/chat_agent.rs:28-137 and
src/ask/responses_agent.rs:28-140): at most ``max_iterations`` (default 20)
LLM turns; every tool call is executed, logged to stdout with its
arguments, and fed back; a turn without tool calls is the final answer;
exhausting iterations yields the "Max iterations (N) reached" message.
stdin mode is a single tool-free completion with the content wrapped in
``<stdin_content>`` tags (chat_agent.rs:149-199).
"""

from __future__ import annotations

import json
import sys
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from semtools_tpu_torch.ask.config import ApiMode, load_ask_config
from semtools_tpu_torch.ask.openai_client import OpenAIClient, response_output_text
from semtools_tpu_torch.ask.prompts import STDIN_SYSTEM_PROMPT, SYSTEM_PROMPT
from semtools_tpu_torch.ask.tools import (
    chat_tool_defs,
    grep_tool,
    read_tool,
    responses_tool_defs,
    search_tool,
)
from semtools_tpu_torch.utils import json_mode


@dataclass
class AskOutput:
    query: str
    response: str
    files_searched: List[str] = field(default_factory=list)


# -- tool dispatch ----------------------------------------------------------


def _parse_search_args(args: Dict):
    from semtools_tpu_torch.search import SearchConfig

    query = args.get("query")
    if query is None:
        raise ValueError("Missing 'query' parameter")
    cfg_json = args.get("config") or {}
    config = SearchConfig(
        n_lines=int(cfg_json.get("n_lines", 5)),
        ignore_case=bool(cfg_json.get("ignore_case", False)),
        max_distance=cfg_json.get("max_distance"),
        top_k=int(cfg_json.get("top_k", 3)),
    )
    return query, config


def _log_search(query: str, config) -> None:
    print("\n[Tool Call: search]")
    print(f'  query: "{query}"')
    print("  config:")
    print(f"    n_lines: {config.n_lines}")
    print(f"    ignore_case: {str(config.ignore_case).lower()}")
    if config.max_distance is not None:
        print(f"    max_distance: {config.max_distance}")
    else:
        print(f"    top_k: {config.top_k}")


def execute_tool_calls(
    calls: List,
    files: List[str],
    model,
    cur_output: "AskOutput",
    workspace_name: Optional[str] = None,
) -> List[str]:
    """Execute one LLM turn's tool calls; outputs in call order.

    Search calls that share a config are served by ONE batched scan
    (tools.search_tool_batched) instead of Q sequential searches — LLMs
    routinely fan out parallel search calls, and per-call execution pays
    Q device dispatch round-trips. Logging stays per-call in the
    original order (the reference's format, tool_calling.rs:46-56).

    Tool faults — malformed JSON arguments, missing required parameters,
    an unknown tool name, or a tool raising mid-execution — become an
    "Error: ..." TOOL OUTPUT for that call only; the turn's other calls
    still run and the agent loop continues, letting the LLM read the
    error and correct itself. (Intentional divergence: the reference
    propagates the first tool error and aborts the whole ask —
    chat_agent.rs:92 / responses_agent.rs:101 use `?` on call_tool — an
    availability hazard for a production agent facing a model that emits
    one bad call.)
    """
    outputs: List[Optional[str]] = [None] * len(calls)
    errors: Dict[int, str] = {}

    groups: Dict = {}
    parsed: Dict[int, tuple] = {}
    for i, (name, args_json) in enumerate(calls):
        if name == "search":
            try:
                query, config = _parse_search_args(json.loads(args_json))
            except Exception as e:  # malformed args: error output, not abort
                errors[i] = f"Error: {e}"
                continue
            parsed[i] = (query, config)
            key = (config.n_lines, config.top_k, config.max_distance,
                   config.ignore_case)
            groups.setdefault(key, []).append(i)

    from semtools_tpu_torch.ask.tools import search_tool_batched

    for idxs in groups.values():
        if len(idxs) < 2:
            continue  # single searches keep the plain path
        config = parsed[idxs[0]][1]
        try:
            batch_out = search_tool_batched(
                files, [parsed[i][0] for i in idxs], model, config,
                cur_output.files_searched, workspace_name,
            )
        except Exception:
            continue  # fall back to the per-call path below
        for i, content in zip(idxs, batch_out):
            outputs[i] = content

    final: List[str] = []
    for i, (name, args_json) in enumerate(calls):
        if i in errors:
            print(f"\n[Tool Call: {name}] FAILED")
            content = errors[i]
        elif outputs[i] is not None:
            query, config = parsed[i]
            _log_search(query, config)
            content = outputs[i]
        elif i in parsed:  # lone search call: reuse the parsed args
            query, config = parsed[i]
            _log_search(query, config)
            try:
                content = search_tool(
                    files, query, model, config,
                    cur_output.files_searched, workspace_name,
                )
            except Exception as e:
                content = f"Error: {e}"
        else:
            try:
                content = call_tool(
                    name, args_json, files, model, cur_output, workspace_name
                )
            except Exception as e:
                print(f"\n[Tool Call: {name}] FAILED")
                content = f"Error: {e}"
        print_tool_summary(content)
        final.append(content)
    return final


def call_tool(
    name: str,
    args_json: str,
    files: List[str],
    model,
    cur_output: AskOutput,
    workspace_name: Optional[str] = None,
) -> str:
    """Parse arguments, log the call, dispatch (src/ask/tool_calling.rs:10-138)."""
    args = json.loads(args_json)

    if name == "grep":
        pattern = args.get("pattern")
        if pattern is None:
            raise ValueError("Missing 'pattern' parameter")
        file_paths = args.get("file_paths")
        is_regex = bool(args.get("is_regex", False))
        case_sensitive = bool(args.get("case_sensitive", True))
        context_lines = int(args.get("context_lines", 3))
        if file_paths:
            for p in file_paths:
                if p not in cur_output.files_searched:
                    cur_output.files_searched.append(p)
        print("\n[Tool Call: grep]")
        print(f'  pattern: "{pattern}"')
        print(f"  is_regex: {str(is_regex).lower()}")
        print(f"  case_sensitive: {str(case_sensitive).lower()}")
        print(f"  context_lines: {context_lines}")
        if file_paths:
            print(f"  file_paths: {file_paths}")
        return grep_tool(files, pattern, file_paths, is_regex, case_sensitive, context_lines)

    if name == "search":
        query, config = _parse_search_args(args)
        _log_search(query, config)
        return search_tool(
            files, query, model, config, cur_output.files_searched, workspace_name
        )

    if name == "read":
        path = args.get("path")
        start_line = args.get("start_line")
        end_line = args.get("end_line")
        if path is None:
            raise ValueError("Missing 'path' parameter")
        if start_line is None:
            raise ValueError("Missing 'start_line' parameter")
        if end_line is None:
            raise ValueError("Missing 'end_line' parameter")
        print("\n[Tool Call: read]")
        print(f"  path: {path}")
        print(f"  start_line: {start_line}")
        print(f"  end_line: {end_line}")
        if path not in cur_output.files_searched:
            cur_output.files_searched.append(path)
        return read_tool(path, int(start_line), int(end_line))

    raise ValueError(f"Unknown tool: {name}")


def print_tool_summary(response: str) -> None:
    """Chunk/line count summary after each call (tool_calling.rs:141-168)."""
    chunk_count = response.count("<chunk")
    total_lines = 0
    for part in response.split("<chunk")[1:]:
        after = part.split(">", 1)
        if len(after) == 2:
            body = after[1].split("</chunk>", 1)[0]
            total_lines += len(body.splitlines())
    if chunk_count:
        print(f"  → Returned {chunk_count} chunk(s) with {total_lines} total lines")
    elif "No matches found" in response:
        print("  → No matches found")
    else:
        print(f"  → Returned {len(response.splitlines())} lines")


# -- agent loops ------------------------------------------------------------


def ask_agent_chat(
    files: List[str],
    user_message: str,
    model,
    client: OpenAIClient,
    api_model: str,
    max_iterations: int = 20,
    workspace_name: Optional[str] = None,
) -> AskOutput:
    result = AskOutput(query=user_message, response="")
    tools = chat_tool_defs()
    messages: List[Dict] = [
        {"role": "system", "content": SYSTEM_PROMPT},
        {"role": "user", "content": user_message},
    ]

    for _ in range(max_iterations):
        message = client.chat_completion(api_model, messages, tools)
        tool_calls = message.get("tool_calls")
        if tool_calls:
            messages.append({"role": "assistant", "tool_calls": tool_calls, "content": None})
            calls = [
                (tc.get("function", {}).get("name", ""),
                 tc.get("function", {}).get("arguments", "{}"))
                for tc in tool_calls
            ]
            contents = execute_tool_calls(calls, files, model, result, workspace_name)
            for tc, content in zip(tool_calls, contents):
                messages.append(
                    {"role": "tool", "tool_call_id": tc.get("id"), "content": content}
                )
        else:
            result.response = message.get("content") or "<No response>"
            return result

    result.response = f"Max iterations ({max_iterations}) reached without final response"
    return result


def ask_agent_responses(
    files: List[str],
    user_message: str,
    model,
    client: OpenAIClient,
    api_model: str,
    max_iterations: int = 20,
    workspace_name: Optional[str] = None,
) -> AskOutput:
    result = AskOutput(query=user_message, response="")
    tools = responses_tool_defs()
    input_items: List[Dict] = [{"role": "user", "content": user_message}]

    for _ in range(max_iterations):
        response = client.responses_create(
            api_model, input_items, SYSTEM_PROMPT, tools, max_output_tokens=4096
        )
        output = response.get("output", [])
        input_items.extend(output)  # echo everything into history

        function_calls = [it for it in output if it.get("type") == "function_call"]
        if function_calls:
            calls = [
                (fc.get("name", ""), fc.get("arguments", "{}"))
                for fc in function_calls
            ]
            contents = execute_tool_calls(calls, files, model, result, workspace_name)
            for fc, content in zip(function_calls, contents):
                input_items.append(
                    {
                        "type": "function_call_output",
                        "call_id": fc.get("call_id"),
                        "output": content,
                    }
                )
        else:
            result.response = response_output_text(response) or "<No response>"
            return result

    result.response = f"Max iterations ({max_iterations}) reached without final response"
    return result


def ask_agent(
    files: List[str],
    user_message: str,
    model,
    client: OpenAIClient,
    api_model: str,
    max_iterations: int = 20,
    workspace_name: Optional[str] = None,
    api_mode: ApiMode = ApiMode.RESPONSES,
) -> AskOutput:
    loop = ask_agent_chat if api_mode == ApiMode.CHAT else ask_agent_responses
    return loop(files, user_message, model, client, api_model, max_iterations, workspace_name)


def ask_agent_with_stdin(
    stdin_content: str,
    user_message: str,
    client: OpenAIClient,
    api_model: str,
    api_mode: ApiMode = ApiMode.RESPONSES,
) -> AskOutput:
    full_message = f"<stdin_content>\n{stdin_content}\n</stdin_content>\n\n{user_message}"
    if api_mode == ApiMode.CHAT:
        message = client.chat_completion(
            api_model,
            [
                {"role": "system", "content": STDIN_SYSTEM_PROMPT},
                {"role": "user", "content": full_message},
            ],
        )
        text = message.get("content")
        if text is None:
            raise RuntimeError("No content in response")
    else:
        response = client.responses_create(
            api_model,
            [{"role": "user", "content": full_message}],
            STDIN_SYSTEM_PROMPT,
            tools=None,
            max_output_tokens=4096,
        )
        text = response_output_text(response) or "<No response>"
    return AskOutput(query=user_message, response=text, files_searched=["<stdin>"])


# -- CLI entry --------------------------------------------------------------


def run_ask(args) -> int:
    """CLI handler: config resolution + stdin/agent dispatch
    (src/cmds/ask.rs:21-136)."""
    cfg = load_ask_config(args.config)

    api_key = args.api_key or cfg.api_key
    if not api_key:
        print(
            "Error: OpenAI API key not found. Set via --api-key, config file, "
            "or OPENAI_API_KEY env var",
            file=sys.stderr,
        )
        return 1
    base_url = args.base_url or cfg.base_url
    model_name = args.model or cfg.model
    api_mode = ApiMode(args.api_mode) if args.api_mode else cfg.api_mode

    client = OpenAIClient(api_key, base_url)

    if not args.files and not sys.stdin.isatty():
        stdin_content = sys.stdin.read()
        if stdin_content.endswith("\n"):
            stdin_content = stdin_content[:-1]
        if stdin_content:
            output = ask_agent_with_stdin(
                stdin_content, args.query, client, model_name, api_mode
            )
            _print_output(output, args.json)
            return 0

    if not args.files:
        msg = "No input provided. Either specify files as arguments or pipe input to stdin."
        if args.json:
            print(json_mode.dumps(json_mode.error_output(msg, "NoInput")), file=sys.stderr)
        else:
            print(msg, file=sys.stderr)
        return 1

    from semtools_tpu_torch.models.static_model import StaticModel

    embed_model = StaticModel.from_pretrained(device=getattr(args, "device", None))
    output = ask_agent(
        list(args.files),
        args.query,
        embed_model,
        client,
        model_name,
        cfg.max_iterations,
        args.workspace,
        api_mode,
    )
    _print_output(output, args.json)
    return 0


def _print_output(output: AskOutput, as_json: bool) -> None:
    if as_json:
        print(
            "\n"
            + json_mode.dumps(
                json_mode.ask_output(output.query, output.response, output.files_searched)
            )
        )
    else:
        print(f"\n{output.response}")
