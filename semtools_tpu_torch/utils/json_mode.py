"""``--json`` output schemas for every command.

Field names and nesting replicate the reference's serde structs
(src/json_mode.rs:4-59) so downstream scripts consuming the reference CLI's
JSON keep working unchanged. Output is pretty-printed with 2-space indent,
matching ``serde_json::to_string_pretty``.

A copy of ``semtools_tpu/utils/json_mode.py``: both packages print the same
schemas.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List


def dumps(obj: Any) -> str:
    return json.dumps(obj, indent=2, ensure_ascii=False)


def parse_result(input_path: str, output_path: str, was_cached: bool) -> Dict:
    return {
        "input_path": input_path,
        "output_path": output_path,
        "was_cached": was_cached,
    }


def parse_output(results: List[Dict]) -> Dict:
    return {"results": results}


def search_result(
    filename: str,
    start_line_number: int,
    end_line_number: int,
    match_line_number: int,
    distance: float,
    content: str,
) -> Dict:
    return {
        "filename": filename,
        "start_line_number": start_line_number,
        "end_line_number": end_line_number,
        "match_line_number": match_line_number,
        "distance": distance,
        "content": content,
    }


def search_output(results: List[Dict]) -> Dict:
    return {"results": results}


def batch_search_line(query: str, results: List[Dict]) -> str:
    """One NDJSON line of ``search --queries-file -j`` output: the
    single-query ``search_output`` schema plus the owning query, compact
    (one query per line keeps the batch streamable through line-oriented
    tools). A batch extension — the reference CLI has no multi-query mode."""
    return json.dumps(
        {"query": query, "results": results}, ensure_ascii=False
    )


def ask_output(query: str, response: str, files_searched: List[str]) -> Dict:
    return {"query": query, "response": response, "files_searched": files_searched}


def workspace_output(
    name: str,
    root_dir: str,
    total_documents: int,
    slots_live: int = None,
    slots_allocated: int = None,
) -> Dict:
    """Reference schema (src/json_mode.rs WorkspaceOutput) plus optional
    slot-occupancy fields so ``workspace status -j`` consumers can see the
    fragmentation the human output hints at."""
    out = {"name": name, "root_dir": root_dir, "total_documents": total_documents}
    if slots_live is not None:
        out["slots_live"] = slots_live
        out["slots_allocated"] = slots_allocated
    return out


def prune_output(files_removed: int, files_remaining: int) -> Dict:
    return {"files_removed": files_removed, "files_remaining": files_remaining}


def error_output(error: str, error_type: str) -> Dict:
    return {"error": error, "error_type": error_type}
