"""The port's probes (semtools_tpu_torch.ops.probes and .probes.*) against
the JAX package's probe kernels, on the same numpy inputs.

The JAX probes are scripts: they are loaded by path, shrunk by setting their
module constants (``N``, ``TILE``, ``NUM_TILES``), and their Pallas calls
run under ``pltpu.force_tpu_interpret_mode()`` on the CPU. P3's six kernel
bodies are closures of its ``main``: they are captured by replacing its
``loop`` and ``_bench``. The ``scripts/probe_int4_opt*.py`` probes run the
chip when imported, so their ``sims_*`` (and ``gen_chunk``) functions are
taken out with ``ast`` and called on arrays, and the 512-row sub-tile maxima
are formed as their ``_kern`` forms them. Nothing of the JAX side changes.

Tolerances: every integer-valued probe is bit-equal (exact products, sums
below 2^24); the bf16 rows of P2 agree within 1e-5 (summation order). The
port runs its plain versions here (CPU tensors); the kernels are held
against those on a card by tests/test_torch_probes_cuda.py.
"""

from __future__ import annotations

import ast
import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from semtools_tpu_torch.ops import probes as pr
from semtools_tpu_torch.probes import int4_sweep, int4_unpack, int8_phase1, kernel_variants, \
    stream_sweep

REPO = Path(__file__).resolve().parents[1]
BF16_TOL = 1e-5


def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name, REPO / rel)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _functions(rel: str, names):
    """The named top-level functions of a script, without running it."""
    tree = ast.parse((REPO / rel).read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == set(names)
    ns = {"jax": jax, "jnp": jnp, "functools": functools, "DIM": 256}
    exec(compile(ast.Module(body=body, type_ignores=[]), rel, "exec"), ns)
    return ns


def _int8(rng, n):
    return rng.integers(-127, 128, (n, 256)).astype(np.int8)


# -- P1: the stream ------------------------------------------------------------


@pytest.mark.parametrize("tile", [256, 512, 1024])
def test_stream_tiles_matches_auto_stream(tile, monkeypatch):
    p1 = _load("benchmarks/quantitative/bench_stream_sweep.py", "p1_stream")
    monkeypatch.setattr(p1, "N", 3 * 1024 + 100)  # rows past the last whole tile
    e = _int8(np.random.default_rng(tile), p1.N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(p1.auto_stream(tile)(jnp.asarray(e), jnp.int32(7)))
    got = pr.stream_tiles(torch.from_numpy(e), tile, 7)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("tile,n_buf", [(64, 2), (64, 4), (128, 3), (32, 8)])
def test_stream_ring_matches_manual_stream(tile, n_buf, monkeypatch):
    p1 = _load("benchmarks/quantitative/bench_stream_sweep.py", "p1_stream")
    monkeypatch.setattr(p1, "N", 20 * tile + 9)
    e = _int8(np.random.default_rng(n_buf), p1.N)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(p1.manual_stream(tile, n_buf)(jnp.asarray(e), jnp.int32(-5)))
    got = pr.stream_ring(torch.from_numpy(e), -5, stage_rows=tile, stages=n_buf)
    assert np.array_equal(got.numpy(), want)


# -- P2: the tile-max sweep ------------------------------------------------------


@pytest.mark.parametrize("dtype,recipe", [("bf16", "plain"), ("int8", "convert_bf16"),
                                          ("int8", "int_dot")])
def test_kernel_variants_match_sweep(dtype, recipe, monkeypatch):
    p2 = _load("benchmarks/quantitative/bench_kernel_variants.py", "p2_variants")
    tile, rows = 512, 3 * 512
    monkeypatch.setattr(p2, "N", rows - 100)  # the mask bites into the last tile
    rng = np.random.default_rng(2)
    x = rng.standard_normal((rows, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    if dtype == "bf16":
        ej = jnp.asarray(x).astype(jnp.bfloat16)
        et = torch.from_numpy(x).to(torch.bfloat16)
        assert np.array_equal(np.asarray(ej.astype(jnp.float32)), et.float().numpy())
    else:
        e8 = np.clip(np.rint(x * 127.0 / np.abs(x).max()), -127, 127).astype(np.int8)
        ej, et = jnp.asarray(e8), torch.from_numpy(e8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(p2.sweep(ej[:8], ej, tile_n=tile, recipe=recipe))[:, 0, :]
    got = pr.tilemax_probe(et[:8], et, p2.N, tile=tile, storage=dtype, recipe=recipe,
                           masked=True)[..., 0].numpy()
    assert got.shape == want.shape and np.array_equal(np.isinf(got), np.isinf(want))
    tol = BF16_TOL if dtype == "bf16" else 0.0
    assert np.abs(got - want).max() <= tol


# -- P3: the int8 phase 1 taken apart -------------------------------------------------


def test_int8_phase1_bodies_match(monkeypatch):
    p3 = _load("benchmarks/quantitative/bench_int8_phase1.py", "p3_phase1")
    monkeypatch.setattr(p3, "TILE", 512)
    monkeypatch.setattr(p3, "NUM_TILES", 3)
    monkeypatch.setattr(p3, "N", 3 * 512)
    captured = []
    monkeypatch.setattr(p3, "loop", lambda phase1: phase1)
    monkeypatch.setattr(p3, "_bench", lambda fn, q8, e8: captured.append((fn, q8, e8)) or 1.0)
    with pltpu.force_tpu_interpret_mode(), contextlib.redirect_stdout(io.StringIO()):
        p3.main()
        want = [np.asarray(fn(q8, e8)) for fn, q8, e8 in captured]
    assert len(want) == len(int8_phase1.BODIES) == 6
    q8, e8 = (torch.from_numpy(np.array(a)) for a in captured[0][1:])
    for w, (key, (recipe, masked, reduce, _)) in zip(want, int8_phase1.BODIES.items()):
        got = pr.tilemax_probe(q8, e8, p3.N, tile=512, storage="int8", recipe=recipe,
                               masked=masked, reduce=reduce)[..., 0].numpy()
        assert np.array_equal(got, w), key


# -- P4: the int4 split-half sweep ------------------------------------------------------


def test_int4_sweep_matches_sweep(monkeypatch):
    p4 = _load("benchmarks/quantitative/bench_int4_sweep.py", "p4_int4")
    rows = 3 * 512
    monkeypatch.setattr(p4, "TILE", 512)
    monkeypatch.setattr(p4, "N", rows - 70)
    rng = np.random.Generator(np.random.Philox(0))
    x = rng.standard_normal((rows, 256), dtype=np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    scale = float(np.max(np.abs(x))) / 7.0
    e4 = p4.pack_int4(x, scale)
    assert np.array_equal(pr.pack_int4(x, scale), e4)
    qv = torch.from_numpy(np.clip(np.rint(x / scale), -7, 7))
    assert np.array_equal(pr.pack_split_half(qv, biased=False).view(torch.uint8).numpy(), e4)
    q8 = np.clip(np.rint(x[:8] / (float(np.max(np.abs(x[:8]))) / 127.0)), -127, 127) \
        .astype(np.int8)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(p4.sweep(jnp.asarray(q8), jnp.asarray(e4)))[:, 0, :]
    got = pr.tilemax_probe(torch.from_numpy(q8), torch.from_numpy(e4), p4.N, tile=512,
                           storage="int4_u8", recipe="convert_bf16", masked=True)[..., 0]
    assert np.array_equal(got.numpy(), want)


# -- P5: the unpack probes -------------------------------------------------------------

OPT = "scripts/probe_int4_opt.py"
OPT2 = "scripts/probe_int4_opt2.py"
SCALE = 0.35 / 7.0


def _values(seed, n):
    x = np.random.default_rng(seed).standard_normal((n, 256)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return np.clip(np.rint(x / SCALE), -7, 7).astype(np.int32)


def _pack(qv, biased):
    """The scripts' own numpy packing (probe_int4_opt2.py's oracle block)."""
    lo = (qv[:, :128] + (8 if biased else 0)) & 0xF
    hi = qv[:, 128:] & 0xF
    return (lo | (hi << 4)).astype(np.int8)


@pytest.mark.parametrize("script", [OPT, OPT2])
def test_gen_chunk_packing(script):
    """The port's split-half packings give the scripts' gen_chunk bytes."""
    ns = _functions(script, ["gen_chunk"])
    ns["scale"] = SCALE
    key = jax.random.PRNGKey(3)
    got = np.asarray(ns["gen_chunk"](key, n=64))
    xx = jax.random.normal(key, (64, 256), dtype=jnp.float32)
    xx = xx / jnp.linalg.norm(xx, axis=1, keepdims=True)
    qv = torch.from_numpy(np.asarray(jnp.clip(jnp.rint(xx / SCALE), -7, 7)).astype(np.int32))
    assert np.array_equal(pr.pack_split_half(qv, biased=script == OPT2).numpy(), got)


@pytest.mark.parametrize("script,fn,storage,biased", [
    (OPT, "sims_shift", "int4_shift", False),
    (OPT, "sims_mask", "int4_and15", False),
    (OPT2, "sims_floor", "int4_floor", True),
    (OPT2, "sims_and", "int4_and15", True),
])
def test_unpack_subtile_max_matches(script, fn, storage, biased):
    sims_fn = _functions(script, [fn])[fn]
    rows = 4 * 512
    qv = _values(5, rows)
    p4 = _pack(qv, biased)
    assert np.array_equal(pr.pack_split_half(torch.from_numpy(qv), biased).numpy(), p4)
    q8 = np.random.default_rng(0).integers(-127, 128, (8, 256)).astype(np.int8)
    sims = np.asarray(sims_fn(jnp.asarray(q8), jnp.asarray(p4)))  # [Q, rows]
    want = sims.reshape(8, rows // 512, 512).max(axis=2)  # make_kernel's _kern
    got = pr.tilemax_probe(torch.from_numpy(q8), torch.from_numpy(p4), tile=rows,
                           storage=storage, recipe="convert_bf16", sub_rows=512)[0]
    assert np.array_equal(got.numpy(), want)


def test_native_subtile_max_matches():
    sims_native = _functions(OPT, ["sims_native"])["sims_native"]
    vals = np.random.default_rng(9).integers(-7, 8, (2 * 512, 256)).astype(np.int32)
    q8 = np.random.default_rng(1).integers(-127, 128, (8, 256)).astype(np.int8)
    sims = np.asarray(sims_native(jnp.asarray(q8), jnp.asarray(vals).astype(jnp.int4)))
    want = sims.reshape(8, 2, 512).max(axis=2)
    p = pr.pack_interleaved(torch.from_numpy(vals))
    got = pr.tilemax_probe(torch.from_numpy(q8), p, tile=1024, storage="int4_native",
                           recipe="convert_bf16", sub_rows=512)[0]
    assert np.array_equal(got.numpy(), want)


# -- P4 and P5 native: the nibbles as biased s8 bytes -------------------------------------

# storage -> the kernel's layout (csrc/probe_tilemax.cu NibbleRows<SPLIT>, <INTERLEAVED>)
NIBBLE_LAYOUTS = {"int4_u8": "split", "int4_native": "interleaved"}


def _nibble_dim(layout: str, off: int, i: int, b: int) -> int:
    """``NibbleRows::dim``: the dim of byte b of word i of the chunk at byte
    offset ``off`` (nibble i % 2 of byte off + 4 (i // 2) + b of the row)."""
    byte, h = off + 4 * (i // 2) + b, i % 2
    return 2 * byte + h if layout == "interleaved" else h * 128 + byte


def _nibble_unpack(e: torch.Tensor, layout: str) -> torch.Tensor:
    """``NibbleRows::unpack`` of every 16-byte chunk, word operation for word
    operation, each s8 byte placed at ``_nibble_dim``: [n, 128] bytes ->
    [n, 256] int64, the biased values n + 8."""
    words = e.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF  # little endian
    out = torch.full((e.shape[0], 256), -1000, dtype=torch.int64)
    for c in range(8):  # chunk c: bytes 16c .. 16c + 15, words 4c .. 4c + 3
        for j in range(4):
            v = words[:, 4 * c + j]
            for h, w in enumerate(((v & 0x0F0F0F0F) ^ 0x08080808,  # one lop3
                                   ((v >> 4) & 0x0F0F0F0F) ^ 0x08080808)):  # a shift, a lop3
                for b in range(4):
                    byte = (w >> (8 * b)) & 0xFF
                    out[:, _nibble_dim(layout, 16 * c, 2 * j + h, b)] = byte - (byte >> 7 << 8)
    return out


@pytest.mark.parametrize("storage", sorted(NIBBLE_LAYOUTS))
def test_nibble_unpack_every_byte(storage):
    """Every byte value at every byte of a word (row r, byte j holds (j + r)
    mod 256): the kernel's s8 bytes are each nibble's two's complement value
    plus 8, at the dims where the plain version puts that nibble; the s8 dot
    less 8 sum(q) is the plain version's dot."""
    layout = NIBBLE_LAYOUTS[storage]
    dims = sorted(_nibble_dim(layout, off, i, b) for off in range(0, 128, 16)
                  for i in range(8) for b in range(4))
    assert dims == list(range(256))  # every dim exactly once a row
    rows = (torch.arange(128)[None, :] + torch.arange(256)[:, None]) % 256
    e = rows.to(torch.uint8).view(pr.STORAGES[storage][0])
    got = _nibble_unpack(e, layout)
    lo, hi = ((rows & 0xF) ^ 8) - 8, ((rows >> 4) ^ 8) - 8  # sext4 of each nibble
    want = torch.stack((lo, hi), 2).flatten(1) if layout == "interleaved" \
        else torch.cat((lo, hi), 1)
    assert torch.equal(got - 8, want)
    assert torch.equal(got - 8, pr.unpack_rows(e, storage).long())
    assert got.min() == 0 and got.max() == 15  # s8 bytes, never negative
    q = torch.from_numpy(np.random.default_rng(6).integers(-127, 128, (8, 256)))
    assert torch.equal(got @ q.T - 8 * q.sum(1), want @ q.T)


def test_floor_full_sims_match_kern_once():
    """P5d: the floor scheme's full sims (sub_rows=1), as _kern_once writes
    them, and the scripts' biased integer oracle; the probe module's own
    call (``floor_case``) and its oracle check, which must see an error."""
    sims_floor = _functions(OPT2, ["sims_floor"])["sims_floor"]
    qv = _values(1, 1024)
    p4 = _pack(qv, biased=True)
    q8 = np.random.default_rng(2).integers(-127, 128, (8, 256)).astype(np.int8)
    want = np.asarray(sims_floor(jnp.asarray(q8), jnp.asarray(p4)))
    case = int4_unpack.floor_case(torch.from_numpy(qv), torch.from_numpy(q8))
    got = case.fn()
    assert got.shape == (1, 8, int4_unpack.CHECK_ROWS)
    got = got[0, :, :1024].numpy()
    assert np.array_equal(got, want)
    expect = q8[:, :128].astype(np.int64) @ (qv[:, :128].T + 8) \
        + q8[:, 128:].astype(np.int64) @ qv[:, 128:].T
    assert np.array_equal(got, expect.astype(np.float32))
    qv_t, q8_t = torch.from_numpy(qv), torch.from_numpy(q8)
    assert int4_unpack.floor_oracle_err(case, qv_t, q8_t) == 0.0
    case.fn = lambda: torch.from_numpy(got[None] + 1)  # a wrong store
    assert int4_unpack.floor_oracle_err(case, qv_t, q8_t) == 1.0


# -- the plain version's edges ------------------------------------------------------------


def test_tilemax_probe_ragged_and_masked_edges():
    """Rows past the corpus do not exist, masked rows read as -inf (and add
    nothing to a sum), a sub-tile with no row counted is -inf."""
    rng = np.random.default_rng(4)
    e = torch.from_numpy(_int8(rng, 2 * 256 + 10))
    q = torch.from_numpy(_int8(rng, 3))
    got = pr.tilemax_probe(q, e, 300, tile=256, storage="int8", recipe="int_dot", masked=True,
                           sub_rows=64)
    assert got.shape == (3, 3, 4)
    sims = (q.double() @ e.double().T).numpy()
    assert np.array_equal(got[1, :, 0].numpy(), sims[:, 256:300].max(axis=1))
    assert torch.isinf(got[1, :, 1:]).all() and torch.isinf(got[2]).all()
    sums = pr.tilemax_probe(q, e, 300, tile=256, storage="int8", recipe="plain", masked=True,
                            reduce="sum")
    assert np.array_equal(sums[:, :, 0].numpy(),
                          np.stack([e[:256, :3].sum(0), e[256:300, :3].sum(0),
                                    torch.zeros(3, dtype=torch.int64)]).astype(np.float32))
    with pytest.raises(ValueError):
        pr.tilemax_probe(q, e, tile=256, storage="int8", recipe="plain", reduce="sum",
                         sub_rows=64)
    with pytest.raises(ValueError):
        pr.stream_ring(e, stage_rows=512, stages=8)  # over a block's shared memory


# -- the kernel's launch shape ------------------------------------------------------------


# (sub_rows, span): the probes' own calls keep their spans: P2's, P3's and
# P4's tile maxima (tiles 2,048-8,192), P5's 512-row sub-tiles (tiles
# 8,192-32,768)
TILES = sorted({c[2] for c in kernel_variants.CASES} | {int8_phase1.TILE, int4_sweep.TILE})
SPANS = [(tile, 1024) for tile in TILES] + [(int4_unpack.SUB, 512)]


@pytest.mark.parametrize("sub_rows,span", SPANS)
def test_subtile_and_tile_maxima_keep_their_spans(sub_rows, span):
    assert pr._span_rows(sub_rows) == span


def test_full_sims_spread_over_the_card():
    """The floor scheme's full sims (one tile of 8,192 rows, sub_rows 1) are
    spans of 64 rows, one warp each: 128 warps, not 8 spans of 1,024."""
    span = pr._span_rows(1)
    assert span == 64 and int4_unpack.CHECK_ROWS // span == 128


# -- the probe modules -----------------------------------------------------------------------------


def _main_out(module, rows):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(["--device", "cpu", "--rows", str(rows)]) == 0
    lines = buf.getvalue().splitlines()
    assert lines[0].startswith("card: none")
    return lines[1:]


def test_probe_modules_print_their_originals_keys():
    p1 = json.loads("\n".join(_main_out(stream_sweep, 30_000)))
    assert {f"auto_tile{t}_gbps" for t in (2048, 4096, 8192, 16384, 24576)} <= set(p1)
    assert {f"manual_t{r}_b{s}_gbps" for r, s in stream_sweep.RINGS} <= set(p1)
    assert p1["stream_roof_gbps"] == "not measured"
    p2 = [json.loads(line) for line in _main_out(kernel_variants, 9000)]
    assert [(d["dtype"], d["recipe"], d["tile"]) for d in p2] == list(kernel_variants.CASES)
    assert all(set(d) == {"dtype", "recipe", "tile", "vecs_per_ms"} for d in p2)
    p3 = json.loads("\n".join(_main_out(int8_phase1, 9000)))
    assert list(p3) == ["phase1_full_vecs_per_ms", "phase1_nomask_vecs_per_ms",
                        "convert_sum_vecs_per_ms", "pure_stream_vecs_per_ms",
                        "int8_direct_dot_vecs_per_ms", "f32_convert_dot_vecs_per_ms",
                        "pure_stream_gbps"]
    p4 = [json.loads(line) for line in _main_out(int4_sweep, 5000)]
    assert p4 == [{"max_tilemax_err": 0.0}, {"int4_sweep_vecs_per_ms": "not measured"}]
    p5 = _main_out(int4_unpack, 9000)
    assert [line.split(":")[0] for line in p5[:-1]] == \
        [f"{name} tile={tile}" for name, _, _, tile in int4_unpack.RUNS]
    assert p5[-1] == "floor-scheme max abs err vs biased int oracle: 0.0"


def test_probe_kernels_are_built_and_counted():
    """The probe sources are in the kernel library's build, and every
    launch counter a probe wrapper moves is registered."""
    from semtools_tpu_torch.ops import kernels

    assert {"stream.cu", "probe_tilemax.cu"} <= set(kernels.SOURCES)
    assert all((kernels.SRC_DIR / src).is_file() for src in kernels.SOURCES)
    counters = {c for _, c in pr.VARIANTS.values()} | {"stream_tiles", "stream_ring"}
    assert counters <= set(kernels.launch_counts())
    assert len({i for i, _ in pr.VARIANTS.values()}) == 11  # csrc/probe_tilemax.cu's instances
