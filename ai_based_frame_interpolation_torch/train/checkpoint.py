"""Checkpoints of the port (JAX ``train/checkpoint.py``, its save and
resume half).

The port's own format, ``torch.save`` of state dicts, in the JAX
package's directory layout:

- ``<dir>/latest`` and ``<dir>/best``: the model's state dict (parameters
  and BatchNorm buffers), the optimizer's state dict, the EMA of the
  parameters when EMA is on, and the step;
- ``<dir>/{latest,best}_meta.json``: the epoch and the history;
- :func:`save_variables` / :func:`load_variables`: an inference export,
  ``<dir>/variables.pt`` (a state dict) and ``<dir>/model_config.json``
  (the JSON keys of the JAX package's).

A resume restores the optimizer's state too (the reference saves it but
never reloads it). Each file is written to a temporary name and renamed,
so a crash mid-save leaves the previous checkpoint whole.

The reference's ``.pth`` (its checkpoint dict, ``model/train.py:232-244``,
or a bare state dict) maps onto the port's U-Net state by name alone:
:func:`import_pth` / :func:`import_state_dict` read it, and
:func:`export_state_dict` / :func:`export_pth` write the dict the JAX
package's ``export_pth`` writes. PyTorch's conv and transposed-conv
layouts are the port's own, so no array is transposed or flipped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..infer.engine import resolve_device


def _tree_of(state) -> Dict[str, Any]:
    tree = {"step": state.step, "model": state.model.state_dict(),
            "opt_state": state.tx.state_dict()}
    if state.ema_params is not None:      # saved only when EMA is on
        tree["ema_params"] = state.ema_params
    return tree


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _write_json(obj, path: str) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


class Checkpointer:
    """Directory layout: ``<dir>/latest`` and ``<dir>/best`` plus
    ``<dir>/{latest,best}_meta.json`` (module docstring). ``device`` is
    where the states it restores live: the card unless ``"cpu"``."""

    def __init__(self, directory: str, device=None):
        self.device = resolve_device(device)
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)

    def _save_one(self, name: str, state, epoch: int, history) -> None:
        _save(_tree_of(state), os.path.join(self.directory, name))
        meta = {"epoch": epoch,
                "history": dataclasses.asdict(history) if history is not None
                else None}
        _write_json(meta, os.path.join(self.directory, f"{name}_meta.json"))

    def save(self, state, epoch: int, history=None, best: bool = False,
             latest: bool = True) -> None:
        if latest:
            self._save_one("latest", state, epoch, history)
        if best:
            self._save_one("best", state, epoch, history)

    def restore(self, template_state, which: str = "best"):
        """Restore into ``template_state`` (a ``TrainState`` of the same
        model and optimizer), in place: the model's state, the optimizer's,
        the step and the EMA (seeded from the restored parameters when the
        checkpoint has none and the template keeps one).

        Returns (state, epoch, history_dict): epoch is the NEXT epoch to
        run.
        """
        path = os.path.join(self.directory, which)
        if not os.path.exists(path) and which == "best":
            which = "latest"            # best never written yet
            path = os.path.join(self.directory, which)
        if not os.path.exists(path):
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        state = template_state
        dev = next(state.model.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"restore: the template lives on {dev}, the "
                             f"checkpointer on {self.device}")
        # read to the host: load_state_dict copies each tensor onto its
        # parameter's device, and keeps Adam's step counts on the host
        tree = torch.load(path, map_location="cpu", weights_only=True)
        state.model.load_state_dict(tree["model"])
        state.tx.load_state_dict(tree["opt_state"])
        state.step = int(tree["step"])
        if state.ema_params is not None:
            src = tree.get("ema_params") or dict(
                state.model.named_parameters())
            with torch.no_grad():
                for name, e in state.ema_params.items():
                    e.copy_(src[name])
        state._scored = None
        meta_path = os.path.join(self.directory, f"{which}_meta.json")
        epoch, history = 0, None
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            epoch = int(meta.get("epoch", -1)) + 1
            history = meta.get("history")
        return state, epoch, history

    def has_checkpoint(self, which: str = "latest") -> bool:
        return os.path.exists(os.path.join(self.directory, which))


def save_variables(directory: str, variables: Mapping[str, torch.Tensor],
                   cfg: Optional[ModelConfig] = None) -> None:
    """Save an inference export: ``variables`` (a state dict, unfolded
    BatchNorm) as ``variables.pt`` and ``cfg`` as ``model_config.json``."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _save({k: v.detach().cpu() for k, v in variables.items()},
          os.path.join(directory, "variables.pt"))
    if cfg is not None:
        _write_json(dataclasses.asdict(cfg),
                    os.path.join(directory, "model_config.json"))


def load_variables(directory: str,
                   template: Optional[Mapping[str, torch.Tensor]] = None
                   ) -> Tuple[Dict[str, torch.Tensor], Optional[ModelConfig]]:
    """Load an inference export; returns (state dict on the CPU, the
    ``ModelConfig`` or None). With ``template`` (a state dict) the keys
    and shapes must match it, and each tensor takes its device and
    dtype."""
    directory = os.path.abspath(directory)
    cfg = None
    cfg_path = os.path.join(directory, "model_config.json")
    if os.path.exists(cfg_path):
        with open(cfg_path) as f:
            cfg = ModelConfig(**json.load(f))
    variables = torch.load(os.path.join(directory, "variables.pt"),
                           map_location="cpu", weights_only=True)
    if template is not None:
        if set(variables) != set(template) or any(
                variables[k].shape != template[k].shape for k in template):
            raise KeyError(f"{directory}: the export's keys or shapes do not "
                           "match the template")
        variables = {k: v.to(template[k]) for k, v in variables.items()}
    return variables, cfg


# ---------------------------------------------------------------------------
# The reference's .pth (JAX ``train/checkpoint.py:167-310``)
# ---------------------------------------------------------------------------

# a DoubleConv's layers: the port's name, then the index in the
# reference's Sequential(conv, bn, relu, conv, bn, relu)
_DOUBLE_CONV = (("conv1", 0), ("conv2", 3), ("bn1", 1), ("bn2", 4))
_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _pth_keys(depth: int, bilinear: bool) -> List[Tuple[str, str]]:
    """(port key, reference key) of every array of the reference U-Net, in
    the order JAX's ``export_state_dict`` writes them."""
    blocks = [("unet.inc", "unet.inc.double_conv")]
    for k in range(1, depth + 1):
        blocks += [(f"unet.down{k}.conv",
                    f"unet.down{k}.maxpool_conv.1.double_conv"),
                   (f"unet.up{k}.conv", f"unet.up{k}.conv.double_conv")]
        if not bilinear:
            blocks.append((f"unet.up{k}.up", None))
    pairs = []
    for port, ref in blocks:
        if ref is None:                        # the 2x2 transposed conv
            pairs += [(f"{port}.{leaf}",) * 2 for leaf in ("weight", "bias")]
            continue
        for name, idx in _DOUBLE_CONV:
            leaves = ("weight",) if name.startswith("conv") else _BN_LEAVES
            pairs += [(f"{port}.{name}.{leaf}", f"{ref}.{idx}.{leaf}")
                      for leaf in leaves]
    pairs += [(f"unet.outc.{leaf}", f"unet.outc.conv.{leaf}")
              for leaf in ("weight", "bias")]
    return pairs


def import_pth(path: str, cfg: Optional[ModelConfig] = None
               ) -> Dict[str, torch.Tensor]:
    """A reference-format ``.pth`` -> the port's unfolded U-Net state dict
    on the CPU.

    Accepts the reference's checkpoint dict (``{'model_state_dict': ...}``)
    or a bare state dict, as the reference's loader does
    (``model/inference.py:83-94``); ``bilinear`` comes from the presence of
    transposed-conv keys when ``cfg`` is not given.
    """
    raw = torch.load(path, map_location="cpu", weights_only=False)
    sd = raw.get("model_state_dict", raw) if isinstance(raw, dict) else raw
    return import_state_dict({k: v for k, v in sd.items()
                              if not k.endswith("num_batches_tracked")}, cfg)


def import_state_dict(sd: Mapping[str, Any],
                      cfg: Optional[ModelConfig] = None
                      ) -> Dict[str, torch.Tensor]:
    """Reference state-dict arrays (tensors or numpy) -> the port's
    unfolded U-Net state dict (f32 on the CPU; BatchNorm's
    ``num_batches_tracked`` 0, which inference never reads)."""
    bilinear = not any(".up.weight" in k for k in sd) if cfg is None \
        else cfg.bilinear
    depth = 4 if cfg is None else cfg.depth
    out: Dict[str, torch.Tensor] = {}
    for port, ref in _pth_keys(depth, bilinear):
        out[port] = torch.as_tensor(np.asarray(sd[ref]), dtype=torch.float32)
        if port.endswith(".running_var"):
            out[port.replace("running_var", "num_batches_tracked")] = \
                torch.tensor(0)
    return out


def pth_config(state: Mapping[str, torch.Tensor]) -> ModelConfig:
    """The ``ModelConfig`` of an imported ``.pth``: the reference's config
    (``ModelConfig()``) with the channels, width, depth and decoder that
    the weights have."""
    w = state["unet.inc.conv1.weight"]
    return ModelConfig(
        channels=int(w.shape[1]) // 2, base_width=int(w.shape[0]),
        depth=sum(1 for k in state if k.startswith("unet.down")
                  and k.endswith(".conv.conv1.weight")),
        bilinear="unet.up1.up.weight" not in state)


def export_state_dict(variables: Mapping[str, torch.Tensor],
                      cfg: Optional[ModelConfig] = None
                      ) -> Dict[str, np.ndarray]:
    """An unfolded port U-Net state dict -> the reference's state-dict
    arrays, the inverse of :func:`import_state_dict`: the arrays JAX's
    ``export_state_dict`` gives for the same weights, bit for bit.

    Raises ``ValueError`` for weights the reference's U-Net has no place
    for (a head, another family) and for folded BatchNorm."""
    cfg = cfg or ModelConfig()
    pairs = _pth_keys(cfg.depth, cfg.bilinear)
    covered = {p for p, _ in pairs}
    extra = sorted(k for k in variables if k not in covered
                   and not k.endswith("num_batches_tracked"))
    if extra:
        raise ValueError("the reference's .pth holds the plain U-Net "
                         "(unfolded BatchNorm, no head); no place for "
                         f"{extra[:4]}")
    return {ref: variables[port].detach().cpu().numpy()
            for port, ref in pairs}


def export_pth(path: str, variables: Mapping[str, torch.Tensor],
               cfg: Optional[ModelConfig] = None, epoch: int = 0,
               train_loss: float = 0.0, val_loss: float = 0.0) -> str:
    """Write a reference-compatible ``best_model.pth`` checkpoint dict (the
    shape of the reference's ``model/train.py:232-244``)."""
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in export_state_dict(variables, cfg).items()}
    torch.save({"epoch": epoch, "model_state_dict": sd,
                "train_loss": train_loss, "val_loss": val_loss}, path)
    return path
