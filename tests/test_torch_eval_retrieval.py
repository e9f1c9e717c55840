"""The port's retrieval evaluation held against the JAX package's driver.

``benchmarks/arxiv/run_retrieval_eval.py`` writes its results beside itself,
so it runs unmodified from a copy in a temporary directory (beside a copy of
``gen_text_corpus.py``) in a child process on the CPU, and the port's
``python -m semtools_tpu_torch.evals retrieval --device cpu`` beside it, both
at the reference's 400 papers. Every per-question record and every family's
means must be equal apart from the times. Beside them: the port's corpus
generator byte-equal to the JAX one over several sizes and seeds, the
agreement metric against the JAX driver's on hand-made cases, and the int8
tier chosen by the store's size rule.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from tests.test_torch_eval_realtext import OFFLINE, child_env, run_both, strip

REPO = Path(__file__).resolve().parent.parent
ARXIV = REPO / "benchmarks" / "arxiv"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("retrieval_eval")
    copy = tmp / "jax_driver"
    copy.mkdir()
    for name in ("run_retrieval_eval.py", "gen_text_corpus.py"):
        shutil.copy(ARXIV / name, copy / name)
    run_both([sys.executable, "-c", OFFLINE, str(copy / "run_retrieval_eval.py")], copy,
             [sys.executable, "-m", "semtools_tpu_torch.evals", "retrieval", "--device", "cpu",
              "--out", str(tmp / "port")], tmp)
    jax = json.loads((copy / "RESULTS_RETRIEVAL.json").read_text())
    port = json.loads((tmp / "port" / "RESULTS_RETRIEVAL.json").read_text())
    return jax, port


QIDS = ["a1", "a2", "a3", "a4", "a5", "b1", "b2", "b3", "b4", "b5",
        "c1", "c2", "c3", "c4", "c5"]


@pytest.mark.parametrize("qid", QIDS)
def test_per_question_record_equal(results, qid):
    jax, port = results
    (want,) = [strip(r) for r in jax["per_question"] if r["question"] == qid]
    (got,) = [strip(r) for r in port["per_question"] if r["question"] == qid]
    assert got == want


def test_per_family_and_batched_equal(results):
    jax, port = results
    assert set(port["per_family"]) == set(jax["per_family"])
    for fam, want in jax["per_family"].items():
        got = dict(port["per_family"][fam])
        want = dict(want)
        got.pop("mean_seconds"), want.pop("mean_seconds")
        assert got == want, fam
    jb, pb = jax["batched_queries_file"], port["batched_queries_file"]
    assert pb["queries"] == jb["queries"]
    assert pb["mean_agreement_with_single_query"] == jb["mean_agreement_with_single_query"]
    assert port["corpus"]["papers"] == jax["corpus"]["papers"] == 400
    assert port["corpus"]["seed"] == jax["corpus"]["seed"]
    assert port["model"] == jax["model"]


def test_tolerant_agreement_and_tier(results):
    """The tolerant agreement (3e-4, one to one) over the same hit lists, the
    tier of the product path at 400 papers (under the int8 size threshold),
    and the device block."""
    _, port = results
    tol = port["tolerant_agreement_at_10"]
    sem = [r["question"] for r in port["per_question"] if r["kind"] == "semantic"]
    assert sorted(tol["int8"]) == sorted(tol["batched"]) == sorted(sem)
    assert tol["mean_int8"] == tol["mean_batched"] == 1.0
    assert port["tier"] == "exact-mxu-scan"
    assert port["corpus"]["lines"] == 24883
    assert port["device"] == {"type": "cpu"}
    assert set(port["launches"]["by_pass"]) == {"build", "product", "exact", "int8", "batched"}


def test_int8_tier_chosen_by_size(tmp_path):
    """With the int8 threshold under the corpus' rows (the rule that picks int8
    on its own past 262,144 rows on the card), the product path serves the
    int8 tier, and its hits agree with the exact scan's."""
    proc = subprocess.run(
        [sys.executable, "-m", "semtools_tpu_torch.evals", "retrieval", "--device", "cpu",
         "--papers", "40", "--out", str(tmp_path / "out")],
        cwd=str(tmp_path), env=child_env(tmp_path, SEMTOOLS_TPU_INT8_MIN_ROWS="1000"),
        capture_output=True, text=True, stdin=subprocess.DEVNULL, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    port = json.loads((tmp_path / "out" / "RESULTS_RETRIEVAL.json").read_text())
    assert port["corpus"]["lines"] > 1000
    assert port["tier"] == "int8-mxu-scan"
    assert port["tolerant_agreement_at_10"]["mean_int8"] == 1.0
    assert port["tolerant_agreement_at_10"]["mean_batched"] == 1.0


# -- the generator ----------------------------------------------------------------


@pytest.mark.parametrize("n_papers,seed", [(8, 7), (40, 7), (400, 7), (57, 3), (130, 11)])
def test_generator_byte_equal(tmp_path, n_papers, seed):
    sys.path.insert(0, str(ARXIV))
    old = sys.dont_write_bytecode
    sys.dont_write_bytecode = True
    try:
        from gen_text_corpus import gen as jax_gen
    finally:
        sys.dont_write_bytecode = old
        sys.path.remove(str(ARXIV))
    from semtools_tpu_torch.evals.corpus import gen

    want_truth = jax_gen(tmp_path / "jax", n_papers=n_papers, seed=seed)
    got_truth = gen(tmp_path / "port", n_papers=n_papers, seed=seed)
    assert got_truth == want_truth
    want = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*")
                 if p.is_file())
    assert got == want and len(got) == 2 * n_papers + 1
    for rel in got:
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes()


# -- the agreement metric -----------------------------------------------------------


def rounded_reference(exact, tier):
    """The JAX driver's agreement, as written at run_retrieval_eval.py:197-222
    (inline there, so it is copied here verbatim)."""
    from collections import Counter

    agree_n = sum(
        (
            Counter(round(h.distance, 5) for h in exact)
            & Counter(round(h.distance, 5) for h in tier)
        ).values()
    )
    return agree_n / max(len(exact), 1)


def hits(*dists):
    return [SimpleNamespace(distance=d) for d in dists]


ROUND_CASES = {
    "identical": (hits(0.1, 0.2, 0.3), hits(0.1, 0.2, 0.3)),
    "ties as a multiset": (hits(0.2, 0.2, 0.5), hits(0.2, 0.5, 0.5)),
    "near tie across rounding": (hits(0.1234549, 0.3), hits(0.12345511, 0.3)),
    "one missing": (hits(0.1, 0.2, 0.3, 0.4), hits(0.1, 0.2, 0.3, 0.9)),
    "empty": (hits(), hits(0.1)),
}


@pytest.mark.parametrize("case", sorted(ROUND_CASES))
def test_rounded_agreement_matches_reference(case):
    from semtools_tpu_torch.evals.common import agree_at_k, rounded_agreement

    ref, got = ROUND_CASES[case]
    assert rounded_agreement(ref, got) == rounded_reference(ref, got)
    if case == "near tie across rounding":
        # two distances 2.1e-7 apart flip the 5-decimal rounding; the
        # tolerant agreement, phase 13's pass rule, sees the same hits
        assert rounded_agreement(ref, got) == 0.5
        assert agree_at_k(ref, got) == 1.0
