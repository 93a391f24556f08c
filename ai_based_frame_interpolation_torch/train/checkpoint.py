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
so a crash mid-save leaves the previous checkpoint whole. The reference's
``.pth`` import and export wait for ROADMAP Queue A, weight interchange.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

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
