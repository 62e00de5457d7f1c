"""Environment fingerprint for timing artifacts (the fingerprint part of
``repro/launch/envcfg.py``).

Kernel timings are comparable only under the environment that produced
them: library versions, the card, the TF32 switches, and the environment
variables that change what runs. The kernel autotuner
(``repro_torch.kernels.autotune``) stamps its caches with this fingerprint
and refuses a cache recorded under another one.

There is nothing to configure here: the reference's x64 and platform pins
are JAX settings. Nothing here creates a CUDA context when no card is
present (``torch.cuda.is_available()`` is checked first).
"""
from __future__ import annotations

import hashlib
import json
import os
import platform
import sys
from typing import Dict, Optional

# Env vars that change which device or code runs, or how fast; captured
# verbatim, with every ``REPRO_*`` var (unset vars are omitted, so an empty
# and an absent var fingerprint alike).
CAPTURED_ENV_VARS = (
    "CUDA_VISIBLE_DEVICES",
    "CUDA_LAUNCH_BLOCKING",
    "CUDA_HOME",
    "NVIDIA_TF32_OVERRIDE",
    "LD_PRELOAD",
    "PYTORCH_CUDA_ALLOC_CONF",
)
CAPTURED_ENV_PREFIX = "REPRO_"


def _triton_version() -> str:
    try:
        import triton
    except ImportError:
        return "missing"
    return getattr(triton, "__version__", "unknown")


def env_fingerprint() -> Dict[str, str]:
    """Stable description of everything that can change a kernel timing.

    Keys are sorted strings so the fingerprint JSON-serializes canonically;
    ``fingerprint_digest`` hashes exactly this dict.
    """
    import numpy as np
    import torch

    has_card = torch.cuda.is_available()
    fp = {
        "cuda": str(torch.version.cuda),
        "device_count": str(torch.cuda.device_count() if has_card else 0),
        "device_name": torch.cuda.get_device_name(0) if has_card else "cpu",
        "machine": platform.machine(),
        "numpy": np.__version__,
        "python": ".".join(map(str, sys.version_info[:3])),
        "system": platform.system(),
        "tf32_cudnn": str(bool(torch.backends.cudnn.allow_tf32)),
        "tf32_matmul": str(bool(torch.backends.cuda.matmul.allow_tf32)),
        "torch": torch.__version__,
        "triton": _triton_version(),
    }
    names = set(CAPTURED_ENV_VARS) | {
        v for v in os.environ if v.startswith(CAPTURED_ENV_PREFIX)}
    for var in names:
        val = os.environ.get(var)
        if val:
            fp[f"env:{var}"] = val
    return dict(sorted(fp.items()))


def fingerprint_digest(fp: Optional[Dict[str, str]] = None) -> str:
    """Short stable hash of a fingerprint (current environment's if None)."""
    if fp is None:
        fp = env_fingerprint()
    blob = json.dumps(fp, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:16]
