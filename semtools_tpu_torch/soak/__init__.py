"""The port's store under faults and random traffic.

Counterpart of the repository's two robustness scripts around the JAX
package (``tests/crash_harness.py`` and ``scripts/soak.py``), for the port's
own store:

- :mod:`semtools_tpu_torch.soak.crash_harness`: SIGKILL crash injection at
  the write paths' phases and at random instants, with the copy-on-write
  contract's verifier;
- :mod:`semtools_tpu_torch.soak.campaigns` (run as ``python -m
  semtools_tpu_torch.soak``): the randomized soak against brute force, four
  campaigns (store tiers, workspace, daemon, crash) on the card or, with
  ``--device cpu``, on the CPU.

Nothing here imports jax or the JAX package, and every process the soak
starts checks that (:func:`check_no_jax`).
"""

import os
import sys
from pathlib import Path

# A subprocess's own time limit (seconds).
CHILD_TIMEOUT = 120
# Where a soak child (``cli_child``) writes its kernel launches at exit.
LAUNCH_DIR_ENV = "SEMTOOLS_SOAK_LAUNCH_DIR"
_REPO = Path(__file__).resolve().parents[2]


def check_no_jax(what: str) -> None:
    """Exit 3 with a message when jax, jaxlib or the JAX package is loaded."""
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "semtools_tpu"))
    if leaked:
        print(f"{what}: the port imported {leaked}", file=sys.stderr)
        sys.exit(3)


def child_env(device: str, **extra) -> dict:
    """This process's environment for a child of the soak: serving on
    ``device``, the repository on the path, plus ``extra``."""
    env = dict(os.environ)
    env.update(
        SEMTOOLS_TORCH_DEVICE=device,
        SEMTOOLS_TPU_NO_FETCH="1",
        SEMTOOLS_TPU_ALLOW_FALLBACK="1",
        PYTHONPATH=os.pathsep.join(p for p in (str(_REPO), env.get("PYTHONPATH", "")) if p),
        **extra,
    )
    return env
