"""Semantic per-line search core.

Counterpart of ``semtools_tpu/search.py``, with the same contract as the
reference's ``src/search/mod.rs``:

- a *document* is a file split into lines; every line is embedded
  independently (truncated at 2048 tokens);
- a search scores the query against every line, keeps lines with
  ``distance < max_distance`` when a threshold is given (all hits,
  unbounded) else the top-k, attaches ``n_lines`` of context before/after
  clamped to the file, and sorts ascending by distance, ties in corpus
  order;
- ``ignore_case`` lowercases query and lines before embedding but reports
  the original text.

The corpus of one search is one [N, D] tensor on the model's device
(:func:`semtools_tpu_torch.ops.scan.topk_scan` scores it; where the store's
sharding policy shards a corpus of this size on the device's mesh, the
sharded scans of :mod:`semtools_tpu_torch.parallel.scan` do).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from semtools_tpu_torch.utils.text import read_file_text, split_lines
from semtools_tpu_torch.models.static_model import StaticModel
from semtools_tpu_torch.ops.scan import batched_threshold_scan, cosine_distances, topk_scan
from semtools_tpu_torch.utils.tracing import span, stage


@dataclass
class Document:
    filename: str
    lines: List[str]
    # [num_lines, dim] float32 unit-or-zero rows (a view of one batched
    # encode's output when built by create_documents_from_contents)
    embeddings: torch.Tensor


@dataclass
class SearchConfig:
    n_lines: int = 3
    top_k: int = 3
    max_distance: Optional[float] = None
    ignore_case: bool = False


@dataclass
class SearchResult:
    filename: str
    lines: List[str]
    start: int  # 0-based, inclusive
    end: int  # 0-based, exclusive
    match_line: int  # 0-based line that matched
    distance: float


def create_document_from_content(
    filename: str, content: str, model: StaticModel, ignore_case: bool
) -> Optional[Document]:
    """Split content into lines and embed each; None for empty content."""
    docs = create_documents_from_contents([(filename, content)], model, ignore_case)
    return docs[0] if docs else None


def create_documents_from_contents(
    items: Sequence[Tuple[str, str]], model: StaticModel, ignore_case: bool
) -> List[Document]:
    """Split each (filename, content) into lines and embed every line of
    every document in one encode. Documents with no lines are dropped."""
    per_doc_lines: List[Tuple[str, List[str]]] = []
    all_lines: List[str] = []
    for filename, content in items:
        lines = split_lines(content)
        if not lines:
            continue
        per_doc_lines.append((filename, lines))
        all_lines.extend(lines)
    if not per_doc_lines:
        return []
    to_embed = [ln.lower() for ln in all_lines] if ignore_case else all_lines
    with stage("embed"):
        embeddings = model.encode(to_embed, max_length=2048)
    docs: List[Document] = []
    offset = 0
    for filename, lines in per_doc_lines:
        docs.append(Document(filename, lines, embeddings[offset : offset + len(lines)]))
        offset += len(lines)
    return docs


def _result_for_line(
    doc: Document, line_idx: int, distance: float, n_lines: int
) -> SearchResult:
    start = max(0, line_idx - n_lines)
    end = min(len(doc.lines), line_idx + n_lines + 1)
    return SearchResult(
        filename=doc.filename,
        lines=doc.lines[start:end],
        start=start,
        end=end,
        match_line=line_idx,
        distance=float(distance),
    )


def _corpus_of(documents: Sequence[Document]) -> Tuple[torch.Tensor, np.ndarray]:
    """The documents' rows as one [N, D] tensor, and each document's first
    flat row ([len(documents) + 1] offsets). Span ``search.corpus``, with
    the bytes the concatenation writes (0 where one tensor is returned)."""
    with span("search.corpus") as sp:
        starts = np.cumsum([0] + [len(d.lines) for d in documents])
        mats = [d.embeddings for d in documents if len(d.lines)]
        if not mats:
            dim = documents[0].embeddings.shape[1] if documents else 0
            return torch.zeros((0, dim), dtype=torch.float32), starts
        if len(mats) == 1:
            return mats[0], starts
        corpus = torch.cat(mats, dim=0)
        sp.count("bytes", corpus.numel() * corpus.element_size())
        return corpus, starts


def search_documents(
    documents: Sequence[Document],
    query_embedding,
    config: SearchConfig,
) -> List[SearchResult]:
    """Single-query scan: a batch of one through
    :func:`search_documents_batched`."""
    q = torch.as_tensor(query_embedding, dtype=torch.float32).reshape(1, -1)
    per = search_documents_batched(documents, q, config)
    return per[0] if per else []


def search_documents_batched(
    documents: Sequence[Document],
    query_embeddings,
    config: SearchConfig,
) -> List[List[SearchResult]]:
    """Q query rows against the same corpus in one scan; per-query results
    match :func:`search_documents`. Threshold overrides top-k with an
    unbounded hit count. Span ``search``, the root of the call's spans."""
    with span("search"):
        qs = torch.as_tensor(query_embeddings, dtype=torch.float32)
        if qs.ndim == 1:
            qs = qs[None]
        qn = int(qs.shape[0])
        if not documents or qn == 0:
            return [[] for _ in range(qn)]
        corpus, starts = _corpus_of(documents)
        if corpus.shape[0] == 0:
            return [[] for _ in range(qn)]

        with stage("scan"):
            from semtools_tpu_torch.parallel.mesh import mesh_size
            from semtools_tpu_torch.store.store import _sharded_enabled

            if _sharded_enabled(int(corpus.shape[0]), mesh_size(corpus.device)):
                from semtools_tpu_torch.parallel import scan as sharded

                if config.max_distance is not None:
                    per = sharded.sharded_batched_threshold_scan(
                        qs, corpus, float(config.max_distance))
                else:
                    per = zip(*sharded.sharded_topk_scan(qs, corpus, config.top_k))
            elif config.max_distance is not None:
                per = batched_threshold_scan(qs, corpus, float(config.max_distance))
            else:
                per = zip(*topk_scan(qs, corpus, config.top_k))
            with span("search.fetch"):
                per = [(d.tolist(), i.tolist()) for d, i in per]

        with span("search.results"):
            out: List[List[SearchResult]] = []
            for dists, idxs in per:
                doc_of = np.searchsorted(starts, idxs, side="right") - 1
                out.append([
                    _result_for_line(documents[di], flat - int(starts[di]), dist, config.n_lines)
                    for dist, flat, di in zip(dists, idxs, doc_of.tolist())
                ])
        return out


def search_files(
    files: Sequence[str],
    query: str,
    model: StaticModel,
    config: SearchConfig,
) -> List[SearchResult]:
    """Read, embed, and search files. IO errors propagate."""
    with stage("read_files"):
        contents = [(f, read_file_text(f)) for f in files]
    documents = create_documents_from_contents(contents, model, config.ignore_case)
    query_text = query.lower() if config.ignore_case else query
    with stage("embed_query"):
        query_embedding = model.encode_single(query_text)
    return search_documents(documents, query_embedding, config)


def _encode_queries(
    queries: Sequence[str], model: StaticModel, config: SearchConfig
) -> torch.Tensor:
    """Embed Q query strings in one encode call; lowercases first under
    ignore_case."""
    texts = [q.lower() for q in queries] if config.ignore_case else list(queries)
    with stage("embed_query"):
        return model.encode(texts, max_length=2048)


def search_files_batched(
    files: Sequence[str],
    queries: Sequence[str],
    model: StaticModel,
    config: SearchConfig,
) -> List[List[SearchResult]]:
    """Batched :func:`search_files`: embed the corpus once, all queries in
    one encode, one scan."""
    if not queries:
        return []
    with stage("read_files"):
        contents = [(f, read_file_text(f)) for f in files]
    documents = create_documents_from_contents(contents, model, config.ignore_case)
    return search_documents_batched(
        documents, _encode_queries(queries, model, config), config
    )


def query_distances(query_embedding, embeddings: torch.Tensor) -> torch.Tensor:
    """Distances of one query against an [N, D] matrix (test/bench helper)."""
    q = torch.as_tensor(query_embedding, dtype=torch.float32).reshape(1, -1)
    return cosine_distances(q.to(embeddings.device), embeddings)[0]


# -- workspace mode -----------------------------------------------------------


def search_with_workspace(
    files: Sequence[str],
    query: str,
    model: StaticModel,
    config: SearchConfig,
    workspace_name: Optional[str] = None,
):
    """Workspace-backed search with incremental re-embedding.

    Mirrors the reference flow (src/search/mod.rs:146-211): classify files
    as new/changed/unchanged via size+mtime+version, re-embed only
    new/changed files, upsert, then run the filtered store scan. Returns
    ``List[RankedLine]`` — (path, line_number, distance) only; context text
    is re-read from the live file at print time.
    """
    per = search_with_workspace_batched(files, [query], model, config, workspace_name)
    return per[0]


def _workspace_update(files, model, config, store) -> None:
    """The incremental re-embed + upsert flow of the workspace searches
    (src/search/mod.rs:164-207), as the JAX package's.

    LINE-LEVEL REUSE: a changed file re-embeds only the lines whose
    content hash is not already present in its stored block (the store's
    ``lines.h64`` sidecar). Embeddings depend only on the (case-folded)
    text, so a hash hit copies the stored f32 row verbatim; duplicate novel
    lines across the whole batch embed once. Reuse is disabled when the
    stored rows predate the current embedding version or model."""
    import sys

    from semtools_tpu_torch.store.store import CURRENT_EMBEDDING_VERSION
    from semtools_tpu_torch.utils.hashing import line_content_hash

    with stage("read_files"):  # stat every file, read the new/changed ones
        states = store.analyze_document_states(files)

    lines_upserted = 0
    lines_reused = 0
    unique_new = 0
    metas = []
    dirty = [s2.info for s2 in states if s2.kind in ("changed", "new")]
    if dirty:
        plan = []  # (info, line hashes, old rows by hash)
        novel: dict = {}  # hash -> text, first occurrence across the batch
        with stage("line_hashes"):
            for info in dirty:
                lines = split_lines(info.content)
                if not lines:
                    continue  # empty docs are skipped (reference returns None)
                texts = [ln.lower() for ln in lines] if config.ignore_case else lines
                hashes = [line_content_hash(t) for t in texts]
                old_rows: dict = {}
                if info.prev_version == CURRENT_EMBEDDING_VERSION:
                    old = store.get_doc_hash_rows(info.filename)
                    if old is not None:
                        oh, orows = old
                        for j, h in enumerate(oh.tolist()):
                            if h and h not in old_rows:
                                old_rows[h] = orows[j]
                for h, t in zip(hashes, texts):
                    if h not in old_rows and h not in novel:
                        novel[h] = t
                plan.append((info, hashes, old_rows))

        novel_rows: dict = {}
        unique_new = len(novel)
        if novel:
            with stage("embed"):
                rows = model.encode(list(novel.values()), max_length=2048).cpu().numpy()
            novel_rows = dict(zip(novel.keys(), rows))

        with stage("store_upsert"):  # assemble each document's rows, write them
            bulk = []
            for info, hashes, old_rows in plan:
                mat = np.stack([
                    old_rows[h] if h in old_rows else novel_rows[h] for h in hashes
                ]).astype(np.float32, copy=False)
                bulk.append((info.filename, mat, np.array(hashes, np.uint64)))
                lines_upserted += len(hashes)
                lines_reused += sum(1 for h in hashes if h in old_rows)
                metas.append(info.meta)
            store.upsert_documents_bulk(bulk)

    if lines_upserted:
        print(
            f"Updating workspace with {lines_upserted} lines from new/changed docs...",
            file=sys.stderr,
        )
        if lines_reused:
            print(
                f"  (reused {lines_reused} cached line embeddings; "
                f"embedded {unique_new} unique new lines)",
                file=sys.stderr,
            )
    if metas:
        print(
            f"Updating workspace with {len(metas)} new/changed documents...",
            file=sys.stderr,
        )
        store.upsert_document_metadata(metas)

    # Refresh the IVF-PQ capacity tier when the corpus is too big for the
    # device tiers (a no-op otherwise or when already fresh).
    with stage("ann_build"):
        store.build_ann_index(verbose=True)


def search_with_workspace_batched(
    files: Sequence[str],
    queries: Sequence[str],
    model: StaticModel,
    config: SearchConfig,
    workspace_name: Optional[str] = None,
):
    """Batched :func:`search_with_workspace`: one incremental update, all
    queries embedded in one encode, one batched store scan. Returns
    ``List[List[RankedLine]]`` in query order."""
    from semtools_tpu_torch.store import Store, Workspace

    if not queries:
        return []
    qs = _encode_queries(queries, model, config).cpu().numpy()
    ws = Workspace.open(workspace_name)
    store = Store(ws.config.root_dir, dim=model.dim, model_name=model.name,
                  device=model.device)
    try:
        _workspace_update(files, model, config, store)
        with stage("store_scan"):
            return store.search_line_embeddings_batched(
                qs, list(files), config.top_k, config.max_distance
            )
    finally:
        store.close()
