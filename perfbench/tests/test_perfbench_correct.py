"""``correct`` comes out false for the control and for a timed path broken
underneath the harness, and true for the program as it is."""

import dataclasses

import pytest

from perfbench import cells, run
from semtools_tpu_torch import search
from conftest import SEED

CELLS = ("arxiv-1k.agent", "arxiv-1k.eval1k", "arxiv-1k.eval1k-m", "lines10m.single")


def _cell(root, name):
    return cells.load_cell(root / "BENCHMARK.json", name, root=root / "perfbench")


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails(tiny_bench, name):
    res = run.execute(_cell(tiny_bench, name), SEED, 0.3, False, device="cpu",
                      tf32_control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]
    assert res["control_checks"]["dist_err"] > res["checks"]["dist_err"]["value"] * 10


def _stale(real):
    last = {}

    def broken(documents, q, config):
        if "answer" not in last:
            last["answer"] = real(documents, q, config)
        return last["answer"]  # the state is returned unchanged
    return broken


def _half_batch(real):
    def broken(documents, q, config):
        out = real(documents, q, config)
        return out[: (len(out) + 1) // 2]  # half of the queries left out
    return broken


def _half_corpus(real):
    def broken(documents, q, config):
        return real(documents[: max(1, len(documents) // 2)], q, config)
    return broken


def _altered(real):
    def broken(documents, q, config):
        out = real(documents, q, config)
        for per in out:
            if per:  # one answer a query, altered where it is produced
                per[0] = dataclasses.replace(per[0], match_line=per[0].match_line ^ 1)
                break
        return out
    return broken


# each fault that a cell can have: a batch of one query has no half to leave out
FAULTS = [(name, fault) for name in CELLS for fault in (_stale, _half_batch, _half_corpus, _altered)
          if fault is not _half_batch or name.startswith("arxiv-1k.eval1k")]


@pytest.mark.parametrize("name, fault", FAULTS)
def test_a_broken_timed_path_is_not_correct(tiny_bench, monkeypatch, name, fault):
    monkeypatch.setattr(search, "search_documents_batched", fault(search.search_documents_batched))
    res = run.execute(_cell(tiny_bench, name), SEED, 0.3, False, device="cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
def test_control_fails_on_the_card_at_the_fused_path(tiny_bench, cuda_device):
    res = run.execute(_cell(tiny_bench, "lines10m.single"), SEED, 1.0, False,
                      device=cuda_device, tf32_control=True)
    assert res["correct"], res["checks"]
    assert not res["control_correct"], res["control_checks"]
    assert res["metrics"]["search_device_ms"]["value"] > 0  # the device's trace was read
