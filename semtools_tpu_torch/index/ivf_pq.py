"""IVF-PQ index: coarse inverted lists + PQ codes + exact re-ranking.

Counterpart of ``semtools_tpu/index/ivf_pq.py``, the workspace's capacity
tier for corpora no device rung fits. Structure:

- a coarse k-means quantizer of C centroids partitions the vectors into
  inverted lists, stored contiguously per list (one permutation array), so
  probing a list is a slice, not a gather;
- each vector's RESIDUAL against its list's centroid is PQ-encoded to M
  bytes; a query ADC-scans only the ``nprobe`` nearest lists, scoring
  ``q . c_list + sum_m table[m, code_m]``;
- an optional exact re-rank of the oversampled candidates against the
  original f32 vectors.

The build runs on a torch device (the card unless the caller asks for the
CPU): k-means and the PQ fit on samples, then one fused assign+encode pass
over the corpus in chunks, the next chunk's upload overlapping the current
chunk, and the list permutation. The query side runs on the host, as in the
JAX package: the native probe (``cpp/adcscan.cpp``) or its numpy version.
``save``/``load`` use the JAX package's npz members, so each package loads
the other's index.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from semtools_tpu_torch.index.kmeans import _assign, kmeans_fit
from semtools_tpu_torch.index.pq import PQCodebook, _encode, adc_tables, pq_encode, pq_fit
from semtools_tpu_torch.utils.tracing import stage

# Elements of the largest per-chunk intermediate of the fused pass: the
# [chunk, nlist] coarse sims or the [chunk, M, 256] PQ sims (128 MB of f32).
_CHUNK_FLOATS = 1 << 25


def _chunk_rows(n: int, nlist: int, m: int) -> int:
    """Rows per chunk of the fused pass: the larger of its two intermediates
    stays within ``_CHUNK_FLOATS``, and a chunk never exceeds the corpus
    (nothing is padded)."""
    return max(1, min(n, _CHUNK_FLOATS // max(nlist, m * 256)))


def _fused_assign_encode(chunk, centroids, c_norm_half, books, cb_norm_half):
    """One build step: ``chunk`` [B, D] f32 -> (assign [B] int64, codes
    [B, M] uint8). Coarse assignment (argmax x.c - |c|^2/2), the residual
    against the assigned centroid, and its per-subspace PQ encoding: the
    math of ``kmeans._assign`` + ``pq._encode`` run separately, fused so
    each row crosses to the device once."""
    sims = chunk @ centroids.T
    a = torch.argmax(sims - c_norm_half[None, :], dim=1)
    res = chunk - centroids[a]
    resh = res.reshape(res.shape[0], books.shape[0], books.shape[2])
    return a, _encode(resh, books, cb_norm_half)


def _rows(x, idx, dev: torch.device) -> torch.Tensor:
    """Rows ``idx`` (a slice or a sorted index array) of ``x`` as f32 on
    ``dev``; ``x`` is a tensor, an array, an mmap or a lazy row view."""
    if torch.is_tensor(x):
        if not isinstance(idx, slice):
            idx = torch.from_numpy(np.asarray(idx)).to(x.device)
        return x[idx].to(dev, torch.float32)
    return torch.from_numpy(np.require(x[idx], np.float32, ["C", "W"])).to(dev)


def _device_chunks(x, n: int, chunk_rows: int, dev: torch.device) -> Iterator[Tuple[int, torch.Tensor]]:
    """(start, rows [start, start + chunk_rows) as f32 on ``dev``) for the
    whole corpus. From the host to a card, each chunk is read into one of
    two pinned buffers and copied on a side stream, and the NEXT chunk is
    read and its copy started only after the caller has launched its work on
    the current one: the host read and the copy overlap the device's work."""
    starts = range(0, n, chunk_rows)
    host_to_card = dev.type == "cuda" and not (torch.is_tensor(x) and x.device == dev)
    if not host_to_card:
        for start in starts:
            yield start, _rows(x, slice(start, start + chunk_rows), dev)
        return
    src = x.cpu() if torch.is_tensor(x) else x
    pinned = [torch.empty((chunk_rows, x.shape[1]), dtype=torch.float32, pin_memory=True)
              for _ in range(2)]
    copied = [None, None]  # the event of each buffer's last copy
    side = torch.cuda.Stream(dev)

    def stage_chunk(i: int, start: int):
        slot = i % 2
        if copied[slot] is not None:
            copied[slot].synchronize()  # the buffer's previous copy is done
        blk = src[start : start + chunk_rows]
        buf = pinned[slot][: blk.shape[0]]
        buf.copy_(blk if torch.is_tensor(blk) else torch.from_numpy(
            np.ascontiguousarray(blk, dtype=np.float32)))
        with torch.cuda.stream(side):
            out = buf.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        copied[slot] = done
        return out, done

    main = torch.cuda.current_stream(dev)
    nxt = stage_chunk(0, 0)
    for i, start in enumerate(starts):
        out, done = nxt
        main.wait_event(done)
        out.record_stream(main)
        yield start, out
        if start + chunk_rows < n:
            nxt = stage_chunk(i + 1, start + chunk_rows)


@dataclass
class IvfPqIndex:
    centroids: np.ndarray  # [C, D]
    pq: PQCodebook
    codes: np.ndarray  # [N, M] uint8, permuted into list order
    perm: np.ndarray  # [N] original index per permuted row
    list_offsets: np.ndarray  # [C + 1] slice bounds into codes/perm
    vectors: Optional[np.ndarray] = None  # [N, D] original rows (list order) for re-rank

    @property
    def n(self) -> int:
        return self.codes.shape[0]

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    # -- build -------------------------------------------------------------

    @classmethod
    def build(
        cls,
        x,
        nlist: int = 256,
        m: int = 32,
        train_iters: int = 10,
        seed: int = 0,
        keep_vectors: bool = True,
        progress=None,
        device=None,
    ) -> "IvfPqIndex":
        """Build over the rows of ``x`` ([N, D]: a numpy array, an mmap, a
        lazy row view with ``shape`` and ``__getitem__``, or a tensor) on
        ``device``: given, else the device of a tensor ``x``, else the
        default (:func:`~semtools_tpu_torch.utils.platform.resolve_device`).
        ``progress``: optional ``callable(str)`` invoked at phase boundaries
        and ~10% steps of the fused pass. Stages (``SEMTOOLS_TPU_TIMINGS``):
        ``ann_train``, ``ann_encode``, ``ann_finalize``."""
        from semtools_tpu_torch.utils.platform import resolve_device

        if device is None and torch.is_tensor(x):
            device = x.device
        dev = resolve_device(device)
        if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
            # TF32 keeps ~3 decimal digits: assignments and codes would
            # differ from the f32 build
            raise RuntimeError("IvfPqIndex.build needs f32 matmuls: TF32 is on "
                               "(torch.backends.cuda.matmul.allow_tf32)")

        def _report(msg: str) -> None:
            if progress is not None:
                progress(msg)

        n = x.shape[0]
        nlist = max(1, min(nlist, n))
        # Quantizers train on samples (the FAISS convention). The sample
        # scales with nlist (~64 rows per centroid, a power of two), as in
        # the JAX package, which draws it with the same numpy generator.
        train_rows = min(n, max(1 << 17, 64 * nlist))
        train_rows = min(n, 1 << (train_rows - 1).bit_length())
        with stage("ann_train"):
            if train_rows < n:
                rng = np.random.default_rng(seed)
                sample = _rows(x, np.sort(rng.choice(n, train_rows, replace=False)), dev)
            else:
                sample = _rows(x, slice(None), dev)
            _report(f"training coarse quantizer ({nlist} lists, {train_rows} sample rows)")
            centroids, _ = kmeans_fit(sample, nlist, iters=train_iters, seed=seed)
            del sample
            chunk_rows = _chunk_rows(n, nlist, m)
            # RESIDUAL PQ (IVFADC): the codebooks train on x - centroid of a
            # sample, so they spend their range on within-list differences;
            # with inner-product scoring q . x = q . c_list + q . residual.
            pq_train_rows = min(n, 65_536)
            if pq_train_rows < n:
                rng_pq = np.random.default_rng(seed + 7)
                srows = _rows(x, np.sort(rng_pq.choice(n, pq_train_rows, replace=False)), dev)
            else:
                srows = _rows(x, slice(None), dev)
            s_assign = torch.cat([_assign(srows[s : s + chunk_rows], centroids)
                                  for s in range(0, srows.shape[0], chunk_rows)])
            pq_train = srows - centroids[s_assign]
            del srows, s_assign
            _report(f"training PQ codebooks (m={m}, {pq_train.shape[0]} residual rows)")
            pq = pq_fit(pq_train, m=m, iters=max(4, train_iters // 2), seed=seed + 1)
            del pq_train

        # ONE fused pass over the corpus, chunked: coarse assignment,
        # residual and PQ codes on the device; only ids and codes stay there
        # until the end.
        _report(f"assigning + encoding {n} rows (fused device pass)")
        n_chunks = -(-n // chunk_rows)
        report_every = max(1, n_chunks // 10)
        books = torch.from_numpy(pq.codebooks).to(dev)
        cb_norm_half = 0.5 * (books * books).sum(dim=2)
        c_norm_half = 0.5 * (centroids * centroids).sum(dim=1)
        with stage("ann_encode"):
            assign = torch.empty(n, dtype=torch.int64, device=dev)
            codes = torch.empty((n, m), dtype=torch.uint8, device=dev)
            for ci, (start, chunk) in enumerate(_device_chunks(x, n, chunk_rows, dev)):
                a, c = _fused_assign_encode(chunk, centroids, c_norm_half, books, cb_norm_half)
                assign[start : start + a.shape[0]] = a
                codes[start : start + a.shape[0]] = c
                if ci % report_every == report_every - 1:
                    _report(f"  processed {min(start + chunk_rows, n)}/{n}")

        with stage("ann_finalize"):
            _report("finalizing (list permutation + publish)")
            perm = torch.argsort(assign, stable=True)
            counts = torch.bincount(assign, minlength=nlist).cpu().numpy()
            offsets = np.zeros(nlist + 1, np.int64)
            np.cumsum(counts, out=offsets[1:])
            codes = codes[perm].cpu().numpy()
            perm = perm.cpu().numpy()
            vectors = _rows(x, perm, torch.device("cpu")).numpy() if keep_vectors else None
        return cls(
            centroids=centroids.cpu().numpy(),
            pq=pq,
            codes=codes,
            perm=perm.astype(np.int64),
            list_offsets=offsets,
            vectors=vectors,
        )

    # -- query (host) --------------------------------------------------------

    def search(
        self,
        q: np.ndarray,
        k: int,
        nprobe: int = 8,
        rerank: int = 16,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Top-k (distances, original indices) for each query row.

        ``rerank`` is the oversampling factor: rerank*k ADC candidates are
        re-scored exactly when the original vectors are kept.
        """
        q = np.asarray(q, np.float32)
        if q.ndim == 1:
            q = q[None]
        nprobe = min(nprobe, self.nlist)
        k = min(k, self.n)
        if k == 0:
            return np.zeros((q.shape[0], 0), np.float32), np.zeros((q.shape[0], 0), np.int64)

        # Coarse probe: nearest lists by dot - |c|^2/2 (L2-to-centroid
        # ordering); the plain dot q.c is kept for the residual ADC offset.
        coarse_dot = q @ self.centroids.T  # [Q, nlist]
        sims = coarse_dot - 0.5 * np.sum(self.centroids**2, axis=1)[None]
        probe_lists = np.argsort(-sims, axis=1)[:, :nprobe]  # [Q, nprobe]
        tables = np.ascontiguousarray(adc_tables(q, self.pq.codebooks), dtype=np.float32)

        out_d = np.zeros((q.shape[0], k), np.float32)
        out_i = np.zeros((q.shape[0], k), np.int64)
        n_cand = max(k * max(1, rerank), k)

        for qi in range(q.shape[0]):
            rows, approx = self._probe(probe_lists[qi], coarse_dot[qi], tables[qi])
            take = min(n_cand, rows.size)
            top = np.argpartition(-approx, take - 1)[:take]

            if self.vectors is not None:
                exact = q[qi] @ self.vectors[rows[top]].T
                order = np.argsort(-exact, kind="stable")[:k]
                sel = top[order]
                out_d[qi, : len(sel)] = 1.0 - exact[order]
            else:
                order = np.argsort(-approx[top], kind="stable")[:k]
                sel = top[order]
                out_d[qi, : len(sel)] = 1.0 - approx[top][order]
            out_i[qi, : len(sel)] = self.perm[rows[sel]]
            if len(sel) < k:
                out_d[qi, len(sel):] = np.inf
                out_i[qi, len(sel):] = -1
        return out_d, out_i

    def _probe(
        self, lists: np.ndarray, coarse_row: np.ndarray, table: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """ADC-scan the probed lists for ONE query.

        Returns (rows, approx): absolute row indices into the permuted code
        matrix and their approximate similarities
        ``q . c_list + sum_m table[m, code_m]``. The native kernel
        (``cpp/adcscan.cpp``) walks the lists' contiguous code slices in
        place; :meth:`_adc_sum_numpy` is its plain version and the
        equivalence oracle.
        """
        starts = np.ascontiguousarray(self.list_offsets[lists])
        ends = np.ascontiguousarray(self.list_offsets[lists + 1])
        total = int(np.sum(ends - starts))
        if total == 0:
            # Degenerate probe (all probed lists empty): fall back to the
            # whole corpus so small/skewed indexes still answer.
            rows = np.arange(self.n)
            row_lists = np.searchsorted(self.list_offsets, rows, side="right") - 1
            offsets_qc = coarse_row[row_lists]
            return rows, offsets_qc + self._adc_sum_numpy(self.codes, table)

        lib = None
        if self.codes.flags.c_contiguous and self.codes.dtype == np.uint8:
            from semtools_tpu_torch.utils import native

            lib = native.adc_lib()
        if lib is not None:
            import ctypes

            bias = np.ascontiguousarray(coarse_row[lists], np.float32)
            table = np.ascontiguousarray(table, np.float32)
            scores = np.empty(total, np.float32)
            rows = np.empty(total, np.int64)
            written = lib.adc_scan_lists(
                self.codes.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_longlong(self.pq.m),
                table.ctypes.data_as(ctypes.c_void_p),
                starts.ctypes.data_as(ctypes.c_void_p),
                ends.ctypes.data_as(ctypes.c_void_p),
                bias.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_longlong(len(lists)),
                scores.ctypes.data_as(ctypes.c_void_p),
                rows.ctypes.data_as(ctypes.c_void_p),
                ctypes.c_longlong(total),
            )
            if written != total:
                raise RuntimeError(f"adc_scan_lists wrote {written} of {total} rows")
            return rows, scores

        blocks = [np.arange(s, e) for s, e in zip(starts, ends)]
        rows = np.concatenate(blocks)
        offsets_qc = np.repeat(coarse_row[lists], [len(b) for b in blocks])
        return rows, offsets_qc + self._adc_sum_numpy(self.codes[rows], table)

    @staticmethod
    def _adc_sum_numpy(cand_codes: np.ndarray, table: np.ndarray) -> np.ndarray:
        """Sum of per-subquantizer table entries, one pass per subspace
        (each gathers from a 1 KB table row)."""
        m = table.shape[0]
        c_t = np.ascontiguousarray(cand_codes.T)
        acc = np.take(table[0], c_t[0]).astype(np.float32, copy=True)
        for j in range(1, m):
            acc += np.take(table[j], c_t[j])
        return acc

    # -- incremental updates (host) -------------------------------------------

    def encode_rows(self, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(list ids, residual PQ codes) for NEW rows under the frozen
        quantizers — the store's reconcile encodes its delta segment with
        this. Host work: deltas are small by the drift bound."""
        x = np.asarray(x, np.float32)
        if x.shape[0] == 0:
            return np.zeros(0, np.int64), np.zeros((0, self.pq.m), np.uint8)
        sims = x @ self.centroids.T - 0.5 * np.sum(self.centroids**2, axis=1)[None]
        assign = np.argmax(sims, axis=1)
        codes = pq_encode(x - self.centroids[assign], self.pq)
        return assign.astype(np.int64), codes

    def score_rows(
        self, q: np.ndarray, codes: np.ndarray, list_ids: np.ndarray
    ) -> np.ndarray:
        """[Q, M_rows] approximate similarities of delta rows: the coarse
        term q . c_list plus the residual ADC table sum — the decomposition
        the probe uses, so delta and main candidates are comparable."""
        q = np.asarray(q, np.float32)
        if codes.shape[0] == 0:
            return np.zeros((q.shape[0], 0), np.float32)
        tables = adc_tables(q, self.pq.codebooks)  # [Q, M, 256]
        coarse = q @ self.centroids.T  # [Q, C]
        m_idx = np.arange(self.pq.m)[None, :]
        codes64 = codes.astype(np.int64)
        resid = np.stack([t[m_idx, codes64].sum(axis=1) for t in tables])
        return coarse[:, list_ids] + resid

    # -- persistence ------------------------------------------------------------

    def save(self, path: str, extra: Optional[dict] = None) -> None:
        """The JAX package's npz members; ``extra`` embeds pairing metadata
        (the store's build token), ignored by :meth:`load`."""
        np.savez_compressed(
            path,
            centroids=self.centroids,
            codebooks=self.pq.codebooks,
            codes=self.codes,
            perm=self.perm,
            list_offsets=self.list_offsets,
            vectors=self.vectors if self.vectors is not None else np.zeros((0, 0), np.float32),
            **(extra or {}),
        )

    @classmethod
    def load(cls, path: str) -> "IvfPqIndex":
        z = np.load(path)
        vectors = z["vectors"]
        return cls(
            centroids=z["centroids"],
            pq=PQCodebook(z["codebooks"]),
            codes=z["codes"],
            perm=z["perm"],
            list_offsets=z["list_offsets"],
            vectors=vectors if vectors.size else None,
        )
