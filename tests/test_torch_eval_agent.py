"""The port's agent evaluation held against the JAX package's driver.

``benchmarks/arxiv/run_agent_eval.py`` writes its transcripts beside itself,
so it runs unmodified from a copy in a temporary directory (beside copies of
``run_retrieval_eval.py`` and ``gen_text_corpus.py``, with the repository's
``tests/`` on the path for its fake server) in a child process on the CPU at
40 papers, and the port's ``python -m semtools_tpu_torch.evals agent --device
cpu --papers 40`` beside it. Every per-question record and every fault record
must be equal apart from ``seconds``, and every transcript equal once the
corpus root is replaced, each ``distance=`` within DIST_TOL (the two
packages' f32 sums differ in the last bits). Beside them: the chunk parser
and the scorer against the JAX driver's on hand-made answers, and the
transcript comparison that ``chip_smoke.py`` applies on the card.
"""

from __future__ import annotations

import json
import os
import re
import runpy
import shutil
import sys
from pathlib import Path

import pytest

from tests.test_torch_eval_realtext import OFFLINE, run_both, strip

REPO = Path(__file__).resolve().parent.parent
ARXIV = REPO / "benchmarks" / "arxiv"
PAPERS = 40
# f32 tolerance of the port's distances against the JAX package's (the
# differences seen are one or two ulps, ~6e-8)
DIST_TOL = 1e-6
ROOT_RE = re.compile(r"(/\S*?semtools_agent_corpus_[^/\s]+)")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("agent_eval")
    copy = tmp / "jax_driver"
    copy.mkdir()
    for name in ("run_agent_eval.py", "run_retrieval_eval.py", "gen_text_corpus.py"):
        shutil.copy(ARXIV / name, copy / name)
    # the copy's own path insertions miss the repository: its fake server
    # comes from the repository's tests/
    wrapper = OFFLINE.replace("import runpy, socket, sys\n", "import runpy, socket, sys\n"
                              f"sys.path.insert(0, {str(REPO / 'tests')!r})\n")
    run_both([sys.executable, "-c", wrapper, str(copy / "run_agent_eval.py"), "--papers",
              str(PAPERS), "--out", str(copy / "RESULTS_AGENT.json")], copy,
             [sys.executable, "-m", "semtools_tpu_torch.evals", "agent", "--device", "cpu",
              "--papers", str(PAPERS), "--out", str(tmp / "port")], tmp)
    jax = json.loads((copy / "RESULTS_AGENT.json").read_text())
    port = json.loads((tmp / "port" / "RESULTS_AGENT.json").read_text())
    return jax, port, copy / "answers", tmp / "port" / "answers"


RUNS = [(mode, qid) for mode in ("responses", "chat")
        for qid in ("a1", "a2", "a3", "a4", "a5", "b1", "b2", "b3", "b4", "b5",
                    "c1", "c2", "c3", "c4", "c5")]


@pytest.mark.parametrize("mode,qid", RUNS)
def test_per_question_record_equal(results, mode, qid):
    jax, port, _, _ = results
    pick = lambda rs: [strip(r) for r in rs if r["question"] == qid and r["api_mode"] == mode]
    (want,), (got,) = pick(jax["per_question"]), pick(port["per_question"])
    assert got == want


FAULTS = [(mode, fault, qid) for mode in ("responses", "chat")
          for fault in ("malformed_json", "unknown_tool", "missing_param", "no_citations",
                        "stall")
          for qid in ("a1", "a2")]


@pytest.mark.parametrize("mode,fault,qid", FAULTS)
def test_fault_record_equal(results, mode, fault, qid):
    jax, port, _, _ = results
    pick = lambda rs: [r for r in rs if (r["api_mode"], r["fault"], r["question"])
                       == (mode, fault, qid)]
    (want,), (got,) = pick(jax["fault_injection"]), pick(port["fault_injection"])
    assert got == want and got["ok"] and not got["crashed"]


def test_aggregate_equal(results):
    jax, port, _, _ = results
    want, got = dict(jax["aggregate"]), dict(port["aggregate"])
    for key in ("wall_seconds", "model_acquisition"):
        want.pop(key), got.pop(key)
    assert got == want
    assert got["fault_injection_ok"] == 20 and got["fault_injection_crashes"] == 0
    assert port["aggregate"]["model_acquisition"]["acquired"] is False
    assert port["device"] == {"type": "cpu"}
    assert set(port["launches"]["by_pass"]) == {"responses", "chat", "faults"}


@pytest.mark.parametrize("mode,qid", RUNS)
def test_transcript_equal(results, mode, qid):
    from semtools_tpu_torch.evals.common import transcript_difference

    _, port, jax_dir, port_dir = results
    want = (jax_dir / mode / f"{qid}.txt").read_text()
    got = (port_dir / mode / f"{qid}.txt").read_text()
    found = ROOT_RE.search(want)
    want_root = found.group(1) if found else "<no corpus path>"
    if found:
        # same prefix, same temporary directory: the same length, so a
        # 400-character cut falls at the same place
        assert len(port["corpus_root"]) == len(want_root)
    assert transcript_difference(got, want, port["corpus_root"], want_root,
                                 DIST_TOL) is None
    if not found:  # grep-only runs with no hit name no file
        assert got == want


# -- the parser, the scorer and the comparison --------------------------------------


@pytest.fixture(scope="module")
def reference():
    """The JAX driver's module globals (loaded by path, writing no bytecode)."""
    old_path, old = list(sys.path), sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        return runpy.run_path(str(ARXIV / "run_agent_eval.py"))
    finally:
        sys.dont_write_bytecode = old
        sys.path[:] = old_path


CHUNK_TEXTS = {
    "search": "<chunk file=/c/x.txt start=3 end=4 distance=0.25>\nline three\n</chunk>\n"
              "<chunk file=/c/y_v3.txt start=0 end=1 distance=0.5>\nTitle (y)\n</chunk>\n",
    "grep": "<chunk file=/c/x.txt start=7 end=8>\nDiffusion here\n</chunk>\n",
    "read": "<chunk file=/c/x.txt start=3 end=6>\na\nb\nc</chunk>\n",
    "empty body": "<chunk file=/c/x.txt start=3 end=3>\n</chunk>\n",
    "none": "No matches found.",
    "error": "Error: Unknown tool: teleport",
}


@pytest.mark.parametrize("case", sorted(CHUNK_TEXTS))
def test_parse_chunks_matches_reference(reference, case):
    from semtools_tpu_torch.evals.common import parse_chunks

    text = CHUNK_TEXTS[case]
    assert parse_chunks(text) == reference["parse_chunks"](text)


def _corpus(tmp_path):
    from semtools_tpu_torch.evals.corpus import TOPICS, gen

    truth = gen(tmp_path / "c", n_papers=20, seed=7)
    return TOPICS, truth


def _answers(tmp_path, topics, truth):
    full = tmp_path / "c" / "full_text"
    att = truth["attention"][0]
    lines = (full / f"{att}.txt").read_text().splitlines()
    bank_line = next(i for i, ln in enumerate(lines) if ln in topics["attention"])
    filler = next(i for i, ln in enumerate(lines) if ln not in topics["attention"] and i > 2)
    other = truth["optimizers"][0]
    f = f"{full}/{att}.txt"
    return {
        "valid": f'{att} states "x" [1].\n\n## References\n[1] {f}:{bank_line}',
        "title": f'{att} states "x" [1].\n\n## References\n[1] {f}:0',
        "range": (f'{att} states "x" [1].\n\n## References\n'
                  f'[1] {f}:{min(filler, bank_line)}-{max(filler, bank_line) + 1}'),
        "scattered": f'x [1].\n\n## References\n[1] {f}:{filler},{bank_line}',
        "fabricated": f'x [1].\n\n## References\n[1] {f}:{filler}',
        "other topic title": f'x [1].\n\n## References\n[1] {full}/{other}.txt:0',
        "out of range": f'x [1].\n\n## References\n[1] {f}:9999',
        "missing file": f'x [1].\n\n## References\n[1] {full}/nope.txt:1',
        "unmatched marker": f'x [1] and [2].\n\n## References\n[1] {f}:{bank_line}',
        "no references": "I believe the answer involves attention, but I am sure.",
    }


@pytest.mark.parametrize("case", ["valid", "title", "range", "scattered", "fabricated",
                                  "other topic title", "out of range", "missing file",
                                  "unmatched marker", "no references"])
@pytest.mark.parametrize("qid", ["a1", "a2"])
def test_score_answer_matches_reference(reference, tmp_path, case, qid):
    from semtools_tpu_torch.evals.agent import score_answer
    from semtools_tpu_torch.evals.retrieval import QUESTIONS

    topics, truth = _corpus(tmp_path)
    answer = _answers(tmp_path, topics, truth)[case]
    question = next(q for q in QUESTIONS if q[0] == qid)
    got = score_answer(answer, question, topics, truth)
    assert got == reference["score_answer"](answer, question, topics, truth)
    if qid == "a1":
        assert got["answered"] == (case in ("valid", "title", "range", "scattered"))


BASE = ("[Tool Output]\n"
        "  <chunk file=/r/a.txt start=1 end=2 distance=0.25>\n  alpha\n  </chunk>\n"
        "  <chunk file=/r/b.txt start=5 end=6 distance=0.2500001>\n  beta\n  </chunk>\n"
        "  <chunk file=/r/c.txt start=2 end=3 distance=0.5>\n  gamma\n  </chunk>\n")


@pytest.mark.parametrize("case,tol,same", [
    ("identical", 0.0, True),
    ("other root", 0.0, True),
    ("ulp apart", 1e-6, True),
    ("ulp apart, exact", 0.0, False),
    ("swapped near tie", 1e-6, True),
    ("swapped, not a tie", 1e-6, False),
    ("cut later", 0.0, True),
    ("other text", 1e-6, False),
])
def test_transcript_difference(case, tol, same):
    from semtools_tpu_torch.evals.common import transcript_difference

    want, root = BASE, "/r"
    got, got_root = BASE, "/r"
    if case == "other root":
        got, got_root = BASE.replace("/r/", "/tmp/q7/"), "/tmp/q7"
    elif case.startswith("ulp apart"):
        got = BASE.replace("0.2500001", "0.25000012")
    elif case == "swapped near tie":
        a, b = BASE.split("  <chunk")[1:3]
        got = BASE.replace("  <chunk" + a + "  <chunk" + b, "  <chunk" + b + "  <chunk" + a)
    elif case == "swapped, not a tie":
        _, a, b, c = BASE.split("  <chunk")
        got = BASE.replace("  <chunk" + b + "  <chunk" + c, "  <chunk" + c + "  <chunk" + b)
    elif case == "cut later":
        want = BASE[:150] + "…[truncated]\nafter\n"
        got = BASE[:170] + "…[truncated]\nafter\n"
    elif case == "other text":
        got = BASE.replace("beta", "delta")
    assert (transcript_difference(got, want, got_root, root, tol) is None) == same
