"""The port's CLI in a child of the soak::

    python -m semtools_tpu_torch.soak.cli_child ARGV...

Runs the command, writes this process's kernel launches to
``$SEMTOOLS_SOAK_LAUNCH_DIR/<pid>.json`` when that is set, then exits with the
command's code, or 3 when jax, jaxlib or the JAX package was loaded.
"""

from __future__ import annotations

import json
import os
import sys
from pathlib import Path

from semtools_tpu_torch.soak import LAUNCH_DIR_ENV, check_no_jax


def main() -> int:
    from semtools_tpu_torch.cli import main as cli_main
    from semtools_tpu_torch.ops import kernels

    code = cli_main(sys.argv[1:])
    out = os.environ.get(LAUNCH_DIR_ENV)
    if out:
        launched = {k: v for k, v in kernels.launch_counts().items() if v}
        (Path(out) / f"{os.getpid()}.json").write_text(json.dumps(launched))
    check_no_jax(f"cli {' '.join(sys.argv[1:3])}")
    return code


if __name__ == "__main__":
    sys.exit(main())
