"""What the probe modules share: arguments, the card's name and power
limit, the seeded data, the cases and their timing.

A case is one kernel call of a probe (its key in the JAX probe's output, the
launch counter it moves, the wrapper call and its plain version on the same
inputs, and the bytes and operations its bound is made of). On the card a
case's time is the least, over TRIALS runs, of CUDA events around REPEATS
back-to-back calls, per call; on the CPU nothing is timed and every rate
reads "not measured".
"""

from __future__ import annotations

import argparse
import contextlib
import os
import subprocess
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

import torch

from semtools_tpu_torch.utils.platform import resolve_device

NOT_MEASURED = "not measured"
SEED = 0  # every corpus and query batch comes from a generator seeded with it
REPEATS, TRIALS = 20, 3
_GEN_ROWS = 1 << 20  # rows made per step: bounds the f32 temporaries


@dataclass
class Case:
    key: str  # the JAX probe's name for this call
    counter: str  # the launch counter (kernels.launch_counts()) it moves
    fn: Callable[[], torch.Tensor]  # the wrapper call
    plain: Callable[[], torch.Tensor]  # the plain version, same inputs
    vectors: int  # corpus rows the call reads
    nbytes: int  # bytes it must move: each input read once, the output written once
    ops: float  # operations on its unit
    unit: str  # the unit whose peak bounds the operations: f32, tf32, bf16 or int8
    library: Optional[Callable[[], torch.Tensor]] = None  # one PyTorch call, same function
    tol: float = 0.0  # against the plain version: 0 is bit-equal
    ms: Optional[float] = None  # per call, on the card
    oracle_err: Optional[float] = None  # max |call - the JAX probe's own oracle|, where it has one


def parser(description: str, rows: int) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    p.add_argument("--rows", type=int, default=rows, help=f"corpus rows (default {rows})")
    return p


@contextlib.contextmanager
def environ(**values: str):
    """The block with ``values`` set in ``os.environ``; the old values (or
    their absence) come back after it."""
    old = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def device_of(args) -> torch.device:
    return resolve_device(args.device)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "card: none (cpu: the plain versions ran; nothing is timed)"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    lines = smi.stdout.strip().splitlines() if smi.returncode == 0 else []
    return f"card: {lines[0] if lines else torch.cuda.get_device_name(device)}"


def generator(device: torch.device, seed: int = SEED) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def unit_rows(n: int, gen: torch.Generator, device: torch.device, transform) -> torch.Tensor:
    """``transform`` of seeded unit-normalised Gaussian rows [n, 256], made
    in steps on ``device``."""
    parts = []
    for start in range(0, n, _GEN_ROWS):
        x = torch.randn((min(_GEN_ROWS, n - start), 256), generator=gen, device=device)
        parts.append(transform(x / x.norm(dim=1, keepdim=True)))
    return torch.cat(parts)


def timed(fn, device: torch.device, reps: int = 1):
    """(the last call's result, host ms, CUDA-events ms) of ``reps``
    back-to-back calls, each time a mean per call and both ended by a
    synchronise; the times are None off the card."""
    if device.type != "cuda":
        return fn(), None, None
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize(device)
    wall = (time.perf_counter() - t0) * 1e3 / reps
    return out, wall, start.elapsed_time(end) / reps


def least(times: List[Optional[float]]):
    """The least of times from :func:`timed`, or "not measured"."""
    return NOT_MEASURED if times[0] is None else min(times)


def time_ms(fn, device: torch.device) -> Optional[float]:
    """Per call: the least over TRIALS of CUDA events around REPEATS
    back-to-back calls; None off the card."""
    fn()
    if device.type != "cuda":
        return None
    return min(timed(fn, device, REPEATS)[2] for _ in range(TRIALS))


def measure(cases: List[Case], device: torch.device) -> None:
    for case in cases:
        case.ms = time_ms(case.fn, device)


def per_ms(count: float, ms: Optional[float]):
    """``count`` per millisecond, or "not measured"."""
    return NOT_MEASURED if ms is None else count / ms


def gbps(nbytes: float, ms: Optional[float]):
    return NOT_MEASURED if ms is None else nbytes / ms / 1e6
