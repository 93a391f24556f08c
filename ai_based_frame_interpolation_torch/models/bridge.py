"""Carry Flax weights into the port's ``state_dict``.

Input: a Flax variables tree of numpy arrays, ``{"params", "batch_stats"}``
(unfolded BatchNorm) or ``{"params"}`` (folded). Conv kernels go from HWIO
to OIHW; the 2x2 transposed conv goes to PyTorch's (in, out, kh, kw) with
its taps flipped (Flax's ``ConvTranspose`` does not flip the kernel,
PyTorch's does); BatchNorm ``scale/bias/mean/var`` become
``weight/bias/running_mean/running_var``. Both ported families map: the
U-Net family (``unet/...``, the heads) and the flow family's single-field
model (``motion_unet/...`` and its head). Any other key raises ``KeyError``,
the flow cascade's ``cascade{k}_*`` among them until the cascade is ported.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Tuple

import numpy as np
import torch

_TOP = ("refine1", "refine2", "refine_out", "refine2_dw", "refine2_pw")
_UNET_BLOCK = re.compile(r"^(inc|outc|down\d+|up\d+)$")
_INNER = ("conv", "conv1", "conv2", "bn1", "bn2", "up")
_BACKBONES = ("unet", "motion_unet")     # U-Net family, flow family


def _check_path(path: Tuple[str, ...]) -> None:
    ok = (len(path) == 1 and path[0] in _TOP) or (
        len(path) >= 2 and path[0] in _BACKBONES
        and _UNET_BLOCK.match(path[1])
        and all(p in _INNER for p in path[2:]))
    if not ok:
        raise KeyError(f"no port module for Flax key {'/'.join(path)}")


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """The port ``state_dict`` for a Flax U-Net- or flow-family variables
    tree."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise KeyError(f"unexpected variable collections {sorted(unknown)}")
    stats = variables.get("batch_stats") or {}
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping, stat: Mapping, path: Tuple[str, ...]) -> None:
        leaves = {k for k, v in node.items() if not isinstance(v, Mapping)}
        if not leaves:
            for key, val in node.items():
                walk(val, stat.get(key, {}), path + (key,))
            return
        _check_path(path)
        if leaves != set(node):
            raise KeyError(f"mixed leaves and modules at {'/'.join(path)}")
        name = ".".join(path)
        if "kernel" in node:
            if leaves - {"kernel", "bias"}:
                raise KeyError(f"unmapped leaves {sorted(leaves)} at {name}")
            k = np.asarray(node["kernel"], np.float32)
            if path[-1] == "up":            # 2x2 stride-2 transposed conv
                k = k[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                k = k.transpose(3, 2, 0, 1)
            out[f"{name}.weight"] = _tensor(k)
            if "bias" in node:
                out[f"{name}.bias"] = _tensor(node["bias"])
        elif leaves == {"scale", "bias"}:
            if set(stat) != {"mean", "var"}:
                raise KeyError(f"BatchNorm {name} has no batch_stats")
            out[f"{name}.weight"] = _tensor(node["scale"])
            out[f"{name}.bias"] = _tensor(node["bias"])
            out[f"{name}.running_mean"] = _tensor(stat["mean"])
            out[f"{name}.running_var"] = _tensor(stat["var"])
            out[f"{name}.num_batches_tracked"] = torch.tensor(0)
        else:
            raise KeyError(f"unmapped leaves {sorted(leaves)} at {name}")

    walk(variables["params"], stats, ())
    return out
