"""Convert model weights between the JAX package's Orbax directories and
the PyTorch port's export directories.

    python3 scripts/torch_convert_orbax.py INPUT OUTPUT

INPUT an Orbax directory, as the JAX package's
``train/checkpoint.py:save_variables`` writes it (``variables/`` and
``model_config.json``): OUTPUT becomes the port's export directory
(``variables.pt`` and ``model_config.json``, as the port's
``train/checkpoint.py:save_variables`` writes it), which
``InterpolationEngine.from_checkpoint`` and ``fi-torch`` load.

INPUT the port's export directory: OUTPUT becomes an Orbax directory that
the JAX package's ``load_variables`` reads.

The weights go through ``models/bridge.py`` (``flax_to_state_dict`` and
``state_dict_to_flax``), every family's keys, bit for bit. Reading and
writing Orbax needs JAX, so this script lives outside the port and runs
where the JAX package is installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402


def orbax_to_export(src: str, dst: str) -> None:
    """A JAX Orbax variables directory -> the port's export directory."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.models.bridge import (
        flax_to_state_dict)
    from ai_based_frame_interpolation_torch.train.checkpoint import (
        save_variables)
    from ai_based_frame_interpolation_tpu.train.checkpoint import (
        load_variables)

    tree, cfg = load_variables(src)
    save_variables(dst, flax_to_state_dict(_to_numpy(tree)),
                   None if cfg is None else
                   ModelConfig(**dataclasses.asdict(cfg)))


def export_to_orbax(src: str, dst: str) -> None:
    """The port's export directory -> a JAX Orbax variables directory."""
    from ai_based_frame_interpolation_torch.models.bridge import (
        state_dict_to_flax)
    from ai_based_frame_interpolation_torch.train.checkpoint import (
        load_variables)
    from ai_based_frame_interpolation_tpu.config import ModelConfig
    from ai_based_frame_interpolation_tpu.train.checkpoint import (
        save_variables)

    state, cfg = load_variables(src)
    tree = state_dict_to_flax(state)
    tree.setdefault("batch_stats", {})     # JAX's save_variables reads it
    save_variables(dst, tree, None if cfg is None else
                   ModelConfig(**dataclasses.asdict(cfg)))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def convert(src: str, dst: str) -> str:
    """Convert ``src`` into ``dst`` in the direction its contents say;
    returns the direction, ``"orbax->export"`` or ``"export->orbax"``."""
    if os.path.exists(os.path.join(src, "variables.pt")):
        export_to_orbax(src, dst)
        return "export->orbax"
    if os.path.isdir(os.path.join(src, "variables")):
        orbax_to_export(src, dst)
        return "orbax->export"
    raise FileNotFoundError(
        f"{src}: neither an Orbax directory (variables/) nor the port's "
        "export directory (variables.pt)")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("input")
    parser.add_argument("output")
    args = parser.parse_args(argv)
    print(f"{args.input} -> {args.output} "
          f"({convert(args.input, args.output)})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
