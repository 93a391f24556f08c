"""Weight interchange between the JAX package's Orbax directories and the
port's export directories: ``models/bridge.py:state_dict_to_flax`` (the
inverse of ``flax_to_state_dict``, every family's keys) and
``scripts/torch_convert_orbax.py``, Flax -> port -> Flax bit for bit,
with the port's engine on the converted export within 1 LSB of JAX's
engine on the original weights (f32, tiny models)."""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch import cli as t_cli
from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.models.bridge import (
    flax_to_state_dict, state_dict_to_flax)
from ai_based_frame_interpolation_torch.models.unet import fold_batchnorm
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.train import checkpoint as j_ckpt
from test_torch_unet import random_variables

SCRIPT = os.path.join(os.path.dirname(__file__), os.pardir, "scripts",
                      "torch_convert_orbax.py")
HW = (32, 32)
FAMILIES = {
    "unet": dict(base_width=4, depth=2, space_to_depth=2, residual=True,
                 refine_width=4),
    "flow": dict(arch="flow", base_width=4, depth=2, refine_width=4,
                 max_flow=4),
}
# every family's keys: the depthwise head, the transposed-conv decoder,
# the tower's projections, the flow family's bidir field and cascade
KEYS = {
    "unet_depthwise": dict(base_width=4, depth=2, space_to_depth=2,
                           refine_width=4, refine_depthwise=True),
    "unet_transposed": dict(base_width=4, depth=2, bilinear=False),
    "tower_slim": dict(arch="tower", base_width=8, depth=2,
                       space_to_depth=2, refine_width=4, slim_decoder=True),
    "flow_bidir_cascade": dict(arch="flow", base_width=4, depth=2,
                               flow_bidir=True, flow_cascade=2,
                               max_flow=4),
}


@pytest.fixture(scope="module")
def script():
    spec = importlib.util.spec_from_file_location("torch_convert_orbax",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_tree(a, b) -> bool:
    return (jax.tree_util.tree_structure(a) ==
            jax.tree_util.tree_structure(b) and
            all(np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(
                jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b))))


@pytest.mark.parametrize("name", list(KEYS))
def test_state_dict_to_flax_inverts_the_bridge(name):
    v = random_variables(KEYS[name], HW, seed=5)
    state = flax_to_state_dict(v)
    assert _same_tree(state_dict_to_flax(state), v)
    folded = state_dict_to_flax(fold_batchnorm(state))
    assert set(folded) == {"params"}
    back = flax_to_state_dict(folded)
    assert all(torch.equal(back[k], t)
               for k, t in fold_batchnorm(state).items())


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_orbax_round_trip_through_the_port(fam, script, tmp_path):
    kw = FAMILIES[fam]
    v = random_variables(kw, HW, seed=6)
    orbax, export, again = (str(tmp_path / n)
                            for n in ("orbax", "export", "again"))
    j_ckpt.save_variables(orbax, v, JConfig(**kw))
    assert script.convert(orbax, export) == "orbax->export"
    teng = TEngine.from_checkpoint(export, compute_dtype=torch.float32,
                                   device="cpu")
    assert teng.cfg == TConfig(**kw)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), v,
                   compute_dtype=jnp.float32)
    gen = np.random.default_rng(7)
    f1, f2 = (gen.integers(0, 256, (2, *HW, 1), np.uint8) for _ in range(2))
    got, want = teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2)
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1
    assert script.convert(export, again) == "export->orbax"
    tree, cfg = j_ckpt.load_variables(again)
    assert cfg == JConfig(**kw) and _same_tree(tree, v)


def test_cli_convert_names_the_script_for_an_orbax_directory(tmp_path,
                                                             capsys):
    j_ckpt.save_variables(str(tmp_path / "orbax"),
                          random_variables(FAMILIES["unet"], HW), None)
    rc = t_cli.main(["convert", "--input", str(tmp_path / "orbax"),
                     "--output", str(tmp_path / "x.pth")])
    assert rc == 1
    assert "scripts/torch_convert_orbax.py" in capsys.readouterr().err
