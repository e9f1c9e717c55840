"""``semtools_tpu_torch.soak.behaviour`` on the CPU at a small size: the
threshold shells (int8, int4, reduced; with and without freed slots), the
dense cluster, masked subsets against the compact path, ``device_cache``
stats, the sharded scans on 4 CPU shards and the native library against its
fallbacks, each against the f32-exact answer. On the CPU the kernels'
wrappers run their plain versions and count no launch; the kernels run in
``tests/test_torch_behaviour_cuda.py`` and ``chip_smoke.py``'s behaviour
phase, whose launches the module checks."""

from __future__ import annotations

import torch

from semtools_tpu_torch.soak import behaviour


def test_behaviour_checks_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setenv("SEMTOOLS_TPU_SHARDED", "0")
    records = behaviour.run_all(3000, 64, torch.device("cpu"), tmp_path)
    checks = [r["check"] for r in records]
    assert len(checks) == 2 * 3 * 3 + 4 + 2 + 4 + 1
    assert all(not r["launches"] for r in records)  # plain versions: no kernel
    shells = [r for r in records if r["check"].startswith("shells")]
    assert {r["tier"] for r in shells} == {"int8-mxu-scan", "int4-mxu-scan",
                                           "int8-mxu-scan-reduced16d"}
    assert [r["served"] for r in records if r["check"].startswith("tiny subset")] == \
        [[behaviour.TINY_ROWS] * 2] * 2
