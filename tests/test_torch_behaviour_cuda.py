"""The behavioural suites' kernel-sensitive cases on a card
(``semtools_tpu_torch.soak.behaviour``, as ``chip_smoke.py``'s behaviour
phase runs them): threshold shells planted below the int8 and int4 error in
a 600,000-row store at d = 256 (with and without freed slots ahead), the
dense cluster, masked subsets (int8, int4) against the compact path, the
sharded fused path on 4 shards of the card, ``device_cache`` stats and the
native library. Every served list must equal the f32-exact one (TF32 off),
and each check must launch the kernels it names. Needs a CUDA card and
skips without one; imports neither jax nor tests/conftest.py's jax setup:

    python -m pytest --noconftest -m cuda tests/test_torch_behaviour_cuda.py -q
"""

from __future__ import annotations

import pytest
import torch

from semtools_tpu_torch.soak import behaviour

PATH = {  # every kernel the checks must reach, summed over them
    "K1a/K1b": ("fused_tilemax", "fused_rescan_topk"),
    "K3a/K3b": ("int8_tilemax", "int8_rescan_topk"),
    "K4a/K4b": ("int8_tilemax_masked", "int8_rescan_topk_masked"),
    "K6": ("int4_sims_max", "int4_sims_max_masked"),
    "sel, K6c, K6x": ("select_subtiles", "int4_cutoff_counts", "int4_extract_above"),
}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the serving kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_behaviour_on_the_card(card, tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    records = behaviour.run_all(600_000, 256, card, tmp_path)
    total = {}
    for r in records:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    for what, names in PATH.items():
        assert all(total.get(k) for k in names), (what, total)
