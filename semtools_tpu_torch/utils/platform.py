"""The device every entry point runs on.

Counterpart of ``semtools_tpu/utils/platform.py``. The device is explicit:
CUDA unless ``cpu`` is asked for (``--device cpu`` or
``SEMTOOLS_TORCH_DEVICE=cpu``). A missing GPU is an error, never a silent
move to the CPU. Resolving the device also joins a multi-process mesh when a
coordinator is configured (:func:`semtools_tpu_torch.parallel.multihost.
initialize`; a no-op otherwise), before anything builds a mesh.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

DEVICE_ENV = "SEMTOOLS_TORCH_DEVICE"


def resolve_device(name: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``name``, else ``$SEMTOOLS_TORCH_DEVICE``, else ``cuda``.

    Raises when a CUDA device is asked for and none is available. Turns TF32
    off for f32 matmuls and convolutions: the reference scores f32 at full
    precision, and TF32 keeps only ~3 decimal digits.
    """
    dev = torch.device(name if name is not None else os.environ.get(DEVICE_ENV) or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device '{dev}' requested but CUDA is not available (no CUDA device); pass "
            f"--device cpu (or set {DEVICE_ENV}=cpu) to run on the CPU"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from semtools_tpu_torch.parallel import multihost

    multihost.initialize(device=dev)
    return dev
