"""The run's surroundings: cache directories inside the checkout, the
card's name, power limit and clocks, and the look for JAX."""

from __future__ import annotations

import os
import subprocess
import sys
from typing import Dict, List, Optional

# top-level module names that no run may hold: JAX, its libraries and the
# JAX package the port came from
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax",
             "ai_based_frame_interpolation_tpu")


def set_caches(root: str) -> None:
    """Fixed cache directories inside the checkout, for whatever builds or
    compiles (the port builds its kernels into its own ``_kernels/``)."""
    cache = os.path.join(root, "benchmark", "_cache")
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(cache, sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> List[str]:
    """The forbidden top-level names that ``sys.modules`` holds, compared
    whole."""
    tops = {name.partition(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def _smi(fields: str) -> Optional[List[str]]:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()


def power_limits() -> Optional[List[float]]:
    """Each card's power limit, W (None where ``nvidia-smi`` does not
    answer)."""
    rows = _smi("power.limit")
    try:
        return [float(r) for r in rows] if rows else None
    except ValueError:
        return None


def clocks() -> Optional[List[Dict[str, str]]]:
    """Each card's SM clock, power draw, power limit and temperature."""
    keys = ("clocks.sm", "power.draw", "power.limit", "temperature.gpu")
    rows = _smi(",".join(keys))
    if rows is None:
        return None
    return [dict(zip(keys, (v.strip() for v in r.split(",")))) for r in rows]
