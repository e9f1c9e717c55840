"""Mesh-sharded serving (counterpart of ``semtools_tpu/parallel``): the
mesh and its corpus shards (:mod:`.mesh`), the sharded scans (:mod:`.scan`),
the multi-process bootstrap (:mod:`.multihost`) and the multi-shard dry run
(:mod:`.dryrun`)."""

from semtools_tpu_torch.parallel import multihost
from semtools_tpu_torch.parallel.mesh import Mesh, ShardedRows, corpus_mesh, shard_corpus
from semtools_tpu_torch.parallel.scan import (
    sharded_int8_topk_scan,
    sharded_threshold_scan,
    sharded_topk_scan,
)

__all__ = ["Mesh", "ShardedRows", "corpus_mesh", "multihost", "shard_corpus",
           "sharded_int8_topk_scan", "sharded_threshold_scan", "sharded_topk_scan"]
