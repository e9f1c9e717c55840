"""The agent evaluation on the port: all 15 questions through ``ask``, scored.

Counterpart of the repository's ``benchmarks/arxiv/run_agent_eval.py``. A
deterministic policy LLM (an in-process OpenAI-compatible server on
localhost that composes each turn from the tool outputs in the request)
drives the port's ``ask_agent`` end to end over the synthetic arxiv-style
corpus (:mod:`semtools_tpu_torch.evals.corpus`) for all 15 questions, in
both API modes (Chat Completions and Responses). The scorer is independent
of the policy: it re-reads every ``[n] file:lines`` reference from disk and
requires the cited line to support the claim (a sentence of the question's
topic bank, or the title of a relevant paper, for semantic questions; a
literal match for grep questions). Then every fault mode of
:data:`FAULT_MODES` runs through both loops on one semantic and one grep
question: the loop must never crash.

Outputs, under ``--out``:
    answers/{responses,chat}/<qid>.txt   30 transcripts
    RESULTS_AGENT.json                   per-question, fault and aggregate scores,
                                         with ``device`` and ``launches``

Run::

    python -m semtools_tpu_torch.evals agent [--device cpu] [--papers 400] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from semtools_tpu_torch.evals import common
from semtools_tpu_torch.evals.retrieval import QUESTIONS

REF_RE = re.compile(r"^\[(\d+)\]\s+(\S+?):([0-9,\-]+)\s*$", re.M)
MARKER_RE = re.compile(r"\[(\d+)\]")


# -- the fake server's transport ------------------------------------------------


class _Handler(BaseHTTPRequestHandler):
    server_version = "FakeServer/1.0"

    def log_message(self, *args):  # silence
        pass

    def _dispatch(self, method: str):
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        status, payload = self.server.app.handle(method, self.path, self.headers, body)
        data = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        self._dispatch("GET")

    def do_POST(self):
        self._dispatch("POST")


class FakeServer:
    """An HTTP server on 127.0.0.1 (a free port) whose every request goes to
    ``app.handle(method, path, headers, body) -> (status, json payload)``."""

    def __init__(self, app):
        self.app = app
        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Handler)
        self.httpd.app = app
        # a short poll: shutdown() waits for it, once per question and fault run
        self.thread = threading.Thread(target=self.httpd.serve_forever,
                                       kwargs={"poll_interval": 0.01}, daemon=True)

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address
        return f"http://{host}:{port}"

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=30)


# -- the policy LLM ------------------------------------------------------------


class PolicyLLM:
    """Deterministic agent policy for one question, served over HTTP.

    Stage k of the conversation (k = number of tool outputs present in
    the request history) either issues plan step k or, once the plan is
    exhausted, composes the final cited answer from every chunk the
    tools returned. The transcript log records each turn.
    """

    def __init__(self, question):
        self.qid, self.family, self.kind, self.query, self.topics = question
        self.log = []

    # transport-level glue -------------------------------------------------

    def handle(self, method, path, headers, body):
        req = json.loads(body) if body else {}
        outputs = self._tool_outputs(path, req)
        self._log_outputs(outputs)
        step = self._plan_step(len(outputs), outputs)
        if step is not None:
            name, args = step
            self.log.append(("tool_call", name, args))
            return self._call_response(path, name, json.dumps(args),
                                       len(outputs))
        answer = self._compose(outputs)
        self.log.append(("answer", answer))
        return self._final_response(path, answer)

    def _log_outputs(self, outputs):
        n_logged = sum(1 for e in self.log if e[0] == "tool_output")
        for out in outputs[n_logged:]:
            head = out if len(out) <= 400 else out[:400] + common.TRUNCATED
            self.log.append(("tool_output", head))

    @staticmethod
    def _call_response(path, name, raw_args, n):
        """A tool-call turn; ``raw_args`` is the LITERAL arguments string
        (the fault modes send intentionally broken JSON through here)."""
        if path.endswith("/responses"):
            return 200, {"output": [{
                "type": "function_call", "name": name,
                "arguments": raw_args,
                "call_id": f"call_{n}", "id": f"fc_{n}",
            }]}
        return 200, {"choices": [{"message": {
            "role": "assistant", "content": None,
            "tool_calls": [{
                "id": f"call_{n}", "type": "function",
                "function": {"name": name, "arguments": raw_args},
            }],
        }}]}

    @staticmethod
    def _final_response(path, answer):
        if path.endswith("/responses"):
            return 200, {"output": [{
                "type": "message", "role": "assistant",
                "content": [{"type": "output_text", "text": answer}],
            }]}
        return 200, {"choices": [{"message": {
            "role": "assistant", "content": answer,
        }}]}

    @staticmethod
    def _tool_outputs(path, req):
        if path.endswith("/responses"):
            return [it.get("output", "") for it in req.get("input", [])
                    if it.get("type") == "function_call_output"]
        return [m.get("content", "") for m in req.get("messages", [])
                if m.get("role") == "tool"]

    # the plan -------------------------------------------------------------

    def _plan_step(self, stage, outputs):
        if self.kind == "grep":
            if stage == 0:
                return "grep", {"pattern": self.query, "context_lines": 0}
            return None
        if stage == 0:
            return "search", {
                "query": self.query,
                "config": {"top_k": 8, "n_lines": 0},
            }
        # cross-reference questions also exercise `read`: pull wider
        # context around the top search hit before answering.
        if stage == 1 and self.family == "cross_reference":
            chunks = common.parse_chunks(outputs[0])
            if chunks:
                f, s, _, _ = chunks[0]
                return "read", {"path": f, "start_line": s, "end_line": s + 3}
        return None

    # the answer -----------------------------------------------------------

    def _compose(self, outputs):
        chunks = []
        for out in outputs:
            chunks.extend(common.parse_chunks(out))
        # one citation per distinct file; the WIDEST chunk for a file wins
        # (a read-tool range beats the single search line it expanded), and
        # file order follows best search rank
        best = {}
        order = []
        for f, s, e, first in chunks:
            if f not in best:
                order.append(f)
                best[f] = (f, s, e, first)
            elif e - s > best[f][2] - best[f][1]:
                best[f] = (f, s, e, first)
        picked = [best[f] for f in order[:5]]
        if not picked:
            return f"No relevant material found for: {self.query}"
        claims, refs = [], []
        for n, (f, s, e, first) in enumerate(picked, 1):
            stem = Path(f).stem
            claims.append(f'{stem} states "{first}" [{n}].')
            if e - s > 1:
                refs.append(f"[{n}] {f}:{s}-{e}")
            else:
                refs.append(f"[{n}] {f}:{s}")
        return (
            f"Findings for: {self.query}\n\n" + "\n".join(claims)
            + "\n\n## References\n" + "\n".join(refs)
        )


# -- fault-injection policy ----------------------------------------------------

FAULT_MODES = (
    "malformed_json",  # first call's arguments are truncated JSON
    "unknown_tool",    # first call names a tool that does not exist
    "missing_param",   # first call omits a required parameter
    "no_citations",    # final answer carries no references section
    "stall",           # never answers: the loop must hit max_iterations
)
RECOVERABLE = ("malformed_json", "unknown_tool", "missing_param")


class FaultyPolicy(PolicyLLM):
    """PolicyLLM with ONE injected fault.

    Recoverable modes (malformed_json / unknown_tool / missing_param) inject
    the broken call at stage 0; the agent loop must feed the "Error: ..."
    back as that call's tool output and keep going, after which the policy
    resumes its normal plan, so the run is scored like a clean one plus the
    requirement that the first tool output is the error. ``no_citations``
    completes the plan but answers without references (the scorer must mark
    it unanswered; the loop must not crash). ``stall`` never stops calling
    tools: the loop must return the verbatim max-iterations message.
    """

    def __init__(self, question, fault: str):
        super().__init__(question)
        if fault not in FAULT_MODES:
            raise ValueError(f"unknown fault mode {fault!r}")
        self.fault = fault

    def _next_call(self, path, stage, outputs, n):
        step = self._plan_step(stage, outputs)
        if step is None:
            return None
        name, args = step
        self.log.append(("tool_call", name, args))
        return self._call_response(path, name, json.dumps(args), n)

    def handle(self, method, path, headers, body):
        req = json.loads(body) if body else {}
        outputs = self._tool_outputs(path, req)
        self._log_outputs(outputs)
        if self.fault == "stall":
            self.log.append(("tool_call", "grep", {"pattern": self.query}))
            return self._call_response(
                path, "grep",
                json.dumps({"pattern": self.query, "context_lines": 0}),
                len(outputs),
            )
        if not outputs:  # stage 0: inject the broken call
            if self.fault == "malformed_json":
                self.log.append(("tool_call", "search", "<malformed json>"))
                return self._call_response(path, "search", '{"query": "x", ', 0)
            if self.fault == "unknown_tool":
                self.log.append(("tool_call", "teleport", {}))
                return self._call_response(path, "teleport", "{}", 0)
            if self.fault == "missing_param":
                self.log.append(("tool_call", "read", {}))
                return self._call_response(path, "read", "{}", 0)
        if self.fault in RECOVERABLE:
            # the error output occupies stage 0; shift the plan down one
            turn = self._next_call(path, len(outputs) - 1, outputs[1:], len(outputs))
            if turn is not None:
                return turn
            answer = self._compose(outputs[1:])
            self.log.append(("answer", answer))
            return self._final_response(path, answer)
        # no_citations: normal plan, citation-free answer
        turn = self._next_call(path, len(outputs), outputs, len(outputs))
        if turn is not None:
            return turn
        answer = f"I believe the answer involves {self.query}, but I am sure."
        self.log.append(("answer", answer))
        return self._final_response(path, answer)


# -- the independent scorer ------------------------------------------------------


def _spec_lines(spec: str):
    """Line indices named by a reference spec (single / a-b range /
    scattered a,b,c), in the tools' 0-based convention."""
    if "-" in spec:
        a, b = spec.split("-")
        return list(range(int(a), int(b)))
    return [int(x) for x in spec.split(",")]


def score_answer(answer: str, question, topic_banks, truth) -> dict:
    qid, family, kind, query, topics = question
    body = answer.split("## References")[0]
    markers = set(MARKER_RE.findall(body))
    refs = {m.group(1): (m.group(2), m.group(3))
            for m in REF_RE.finditer(answer)}
    structural = bool(refs) and markers == set(refs)

    if kind == "grep":
        def supports(path, idx, line):
            return query in line
    else:
        bank = set()
        relevant_pids = set()
        for t in topics:
            bank |= set(topic_banks[t])
            relevant_pids |= set(truth[t])

        def supports(path, idx, line):
            # A citation checks out when the cited line is one of the
            # question's topic-bank sentences, or it is the TITLE line
            # (index 0) of a paper the ground truth marks relevant.
            if line in bank:
                return True
            return idx == 0 and Path(path).stem in relevant_pids

    checked = []
    for n, (f, spec) in refs.items():
        ok = False
        try:
            lines = Path(f).read_text().splitlines()
            idxs = _spec_lines(spec)
            ok = all(0 <= i < len(lines) for i in idxs) and any(
                supports(f, i, lines[i]) for i in idxs
            )
        except (OSError, ValueError):
            ok = False
        checked.append(ok)
    n_valid = sum(checked)
    return {
        "question": qid, "family": family, "kind": kind,
        "citations": len(refs), "citations_valid": n_valid,
        "citation_validity": n_valid / max(len(refs), 1),
        "structural_ok": structural,
        "answered": structural and n_valid > 0,
    }


def transcript(question, policy, result, mode) -> str:
    qid, family, kind, query, _ = question
    lines = [
        f"# question {qid} ({family}, {kind}) — api mode: {mode}",
        f"Q: {query}",
        "",
    ]
    for entry in policy.log:
        if entry[0] == "tool_call":
            lines.append(f"[Tool Call: {entry[1]}] {json.dumps(entry[2])}")
        elif entry[0] == "tool_output":
            lines.append("[Tool Output]")
            lines.extend("  " + ln for ln in entry[1].splitlines())
        else:
            lines.append("")
            lines.append(entry[1])
    lines += [
        "",
        f"# scoring: citations {result['citations_valid']}/{result['citations']}"
        f" valid; answered={result['answered']}",
    ]
    return "\n".join(lines) + "\n"


# -- the run --------------------------------------------------------------------


def _ask(files, question, model, policy, mode):
    from semtools_tpu_torch.ask.agent import ask_agent
    from semtools_tpu_torch.ask.openai_client import OpenAIClient

    with FakeServer(policy) as server:
        client = OpenAIClient("eval-key", server.url)
        return ask_agent(files, question[3], model, client, "policy-llm",
                         max_iterations=20, workspace_name="agent-eval", api_mode=mode)


def run_fault_injection(files, model, modes, topic_banks, truth) -> list:
    """Every fault mode through both API loops on a representative semantic
    question and a grep question. Records crashed / recovered /
    expected-behaviour flags; 0 crashes is the gate."""
    picks = [QUESTIONS[0], next(q for q in QUESTIONS if q[2] == "grep")]
    records = []
    for mode in modes:
        for fault in FAULT_MODES:
            for question in picks:
                policy = FaultyPolicy(question, fault)
                rec = {
                    "fault": fault, "question": question[0],
                    "api_mode": mode.value,
                }
                try:
                    out = _ask(files, question, model, policy, mode)
                except Exception as e:  # noqa: BLE001 - the gate: must never happen
                    rec.update(crashed=True, error=repr(e))
                    records.append(rec)
                    continue
                rec["crashed"] = False
                first_out = next(
                    (e[1] for e in policy.log if e[0] == "tool_output"), ""
                )
                if fault in RECOVERABLE:
                    s = score_answer(out.response, question, topic_banks, truth)
                    rec["error_fed_back"] = first_out.startswith("Error:")
                    rec["recovered_answered"] = bool(s["answered"])
                    rec["citation_validity"] = s["citation_validity"]
                    rec["ok"] = rec["error_fed_back"] and rec["recovered_answered"]
                elif fault == "no_citations":
                    s = score_answer(out.response, question, topic_banks, truth)
                    rec["scored_unanswered"] = not s["answered"]
                    rec["ok"] = rec["scored_unanswered"]
                else:  # stall
                    rec["max_iterations_message"] = out.response
                    rec["ok"] = out.response == (
                        "Max iterations (20) reached without final response"
                    )
                records.append(rec)
    return records


def run(dev, n_papers: int, out_dir: str, corpus_root: Path) -> dict:
    from semtools_tpu_torch.ask.config import ApiMode
    from semtools_tpu_torch.evals.corpus import TOPICS, gen
    from semtools_tpu_torch.evals.retrieval import SEED
    from semtools_tpu_torch.models.static_model import load_model
    from semtools_tpu_torch.store import Workspace

    truth = gen(corpus_root, n_papers=n_papers, seed=SEED)
    files = sorted(str(p) for p in (corpus_root / "full_text").glob("*.txt"))
    acquisition = common.attempt_model_acquisition()
    model = load_model(device=dev)
    common.warm_up(dev)
    launches = common.LaunchLog()
    os.environ["SEMTOOLS_WORKSPACE"] = "agent-eval"
    Workspace.open("agent-eval").save()

    results = []
    t_start = time.perf_counter()
    for mode in (ApiMode.RESPONSES, ApiMode.CHAT):
        mode_dir = Path(out_dir) / "answers" / mode.value
        mode_dir.mkdir(parents=True, exist_ok=True)
        for question in QUESTIONS:
            policy = PolicyLLM(question)
            t0 = time.perf_counter()
            with launches.measure(mode.value):
                out = _ask(files, question, model, policy, mode)
            dt = time.perf_counter() - t0
            r = score_answer(out.response, question, TOPICS, truth)
            r.update({
                "api_mode": mode.value,
                "tool_calls": sum(1 for e in policy.log if e[0] == "tool_call"),
                "files_searched": len(out.files_searched),
                "seconds": dt,
            })
            results.append(r)
            (mode_dir / f"{question[0]}.txt").write_text(
                transcript(question, policy, r, mode.value)
            )
            print(json.dumps(r))

    with launches.measure("faults"):
        faults = run_fault_injection(files, model, (ApiMode.RESPONSES, ApiMode.CHAT),
                                     TOPICS, truth)
    for r in faults:
        print(json.dumps(r))

    agg = {
        "questions": len(QUESTIONS),
        "api_modes": 2,
        "papers": n_papers,
        "model": getattr(model, "name", "unknown"),
        "total_citations": sum(r["citations"] for r in results),
        "total_citations_valid": sum(r["citations_valid"] for r in results),
        "citation_validity": (
            sum(r["citations_valid"] for r in results)
            / max(sum(r["citations"] for r in results), 1)
        ),
        "answered": sum(r["answered"] for r in results),
        "fault_injection_runs": len(faults),
        "fault_injection_crashes": sum(1 for r in faults if r["crashed"]),
        "fault_injection_ok": sum(1 for r in faults if r.get("ok")),
        "wall_seconds": time.perf_counter() - t_start,
        "model_acquisition": acquisition,
    }
    payload = {"aggregate": agg, "per_question": results, "fault_injection": faults,
               "corpus_root": str(corpus_root), "device": common.device_block(dev),
               "launches": launches.report()}
    common.write_results(out_dir, "RESULTS_AGENT.json", payload)
    print(json.dumps({"aggregate": agg}))
    return payload


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m semtools_tpu_torch.evals agent",
                                 description=__doc__.split("\n\n")[0])
    common.add_common_args(ap)
    ap.add_argument("--papers", type=int, default=400,
                    help="papers the corpus generator writes (default 400)")
    args = ap.parse_args(argv)
    dev = common.open_device(args.device)
    with common.eval_env("semtools_agent_corpus_", SEMTOOLS_TPU_DAEMON="off") as corpus_root:
        run(dev, args.papers, args.out, corpus_root)
    return 0
