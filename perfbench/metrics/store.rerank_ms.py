"""The program's ``tier_rerank`` stage a request: the exact float32 re-rank
on the host of a quantized tier's candidate pool (a gather of its rows from
the store's file, a product with the queries, a sort)."""


def read(r):
    return r.stage_ms_per_request("tier_rerank")
