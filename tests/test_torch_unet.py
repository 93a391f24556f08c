"""Port U-Net family vs the JAX/Flax model on bridged weights.

Every weight, bias and BatchNorm statistic is drawn from a seeded numpy
generator (Flax's init would leave biases at 0 and BatchNorm at mean 0,
var 1, which makes folding trivial), carried into the port through
``models/bridge.py`` and run in f32 on both sides. Outputs agree to 1e-4:
the same f32 convolutions summed in another order, a few ulp of values of
order 1-10.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.models.unet import (
    count_parameters as t_count, fold_batchnorm as t_fold)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models.unet import (
    fold_batchnorm as j_fold)

PARITY = dict(base_width=4, depth=2)                       # s2d 1, align_corners
PRODUCTION = dict(base_width=8, depth=2, space_to_depth=4, residual=True,
                  refine_width=8, upsample="half_pixel")
CASES = {
    "parity": (PARITY, (32, 40)),
    "production": (PRODUCTION, (32, 48)),
    "transposed_conv": (dict(PARITY, bilinear=False), (32, 40)),
    "time_depthwise_factor2": (dict(PRODUCTION, time_conditioned=True,
                                    refine_depthwise=True, refine_factor=2),
                               (32, 48)),
}


def random_variables(cfg_kwargs, hw, seed=0):
    """A Flax variables tree of the model's shapes (``eval_shape``: nothing
    compiles), every leaf drawn from numpy."""
    model = j_build(JConfig(**cfg_kwargs), jnp.float32)
    f = jax.ShapeDtypeStruct((1, *hw, JConfig(**cfg_kwargs).channels),
                             jnp.float32)
    variables = jax.eval_shape(lambda a: model.init(jax.random.key(0), a, a,
                                                    train=False), f)
    gen = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        shape = leaf.shape
        if "var" in name:
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        if "kernel" in name:
            fan_in = int(np.prod(shape[:-1]))
            return (gen.standard_normal(shape) / np.sqrt(fan_in)).astype(
                np.float32)
        if "scale" in name:
            return gen.uniform(0.5, 1.5, shape).astype(np.float32)
        return (0.1 * gen.standard_normal(shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _frames(hw, c, n=2, seed=1):
    gen = np.random.default_rng(seed)
    return [gen.uniform(-1, 1, (n, *hw, c)).astype(np.float32)
            for _ in range(2)]


def _port(cfg_kwargs, state, folded):
    model = t_build(TConfig(**cfg_kwargs), torch.float32, folded=folded)
    model.load_state_dict(state)
    return model.eval()


def _run_port(model, f1, f2, **kw):
    with torch.inference_mode():
        out = model(torch.from_numpy(f1.transpose(0, 3, 1, 2)),
                    torch.from_numpy(f2.transpose(0, 3, 1, 2)), **kw)
    return out.permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("name,kw", [("default", {}),
                                     ("production", dict(
                                         space_to_depth=4, residual=True,
                                         refine_width=64,
                                         upsample="half_pixel"))])
def test_count_parameters_matches_jax(name, kw):
    jmodel = j_build(JConfig(**kw))
    f = jax.ShapeDtypeStruct((1, 64, 64, 1), jnp.float32)
    shapes = jax.eval_shape(lambda a, b: jmodel.init(jax.random.key(0), a, b,
                                                     train=False), f, f)
    want = sum(int(np.prod(x.shape))
               for x in jax.tree.leaves(shapes["params"]))
    with torch.device("meta"):
        got = t_count(t_build(TConfig(**kw)))
    assert got == want
    if name == "default":
        assert got == 17_262_401


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("folded", [False, True])
def test_forward_matches_jax(case, folded):
    kw, hw = CASES[case]
    variables = random_variables(kw, hw)
    jmodel = j_build(JConfig(**kw), jnp.float32, folded=folded)
    if folded:
        variables = jax.tree.map(np.asarray, j_fold(variables))
    f1, f2 = _frames(hw, JConfig(**kw).channels)
    t = np.array([0.3, 0.7], np.float32)
    extra = {"t": t} if kw.get("time_conditioned") else {}
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, **{k: jnp.asarray(x) for k, x in extra.items()}))(
        variables, f1, f2), np.float32)
    model = _port(kw, flax_to_state_dict(variables), folded)
    got = _run_port(model, f1, f2,
                    **{k: torch.from_numpy(x) for k, x in extra.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_fold_batchnorm_matches_jax():
    kw, hw = CASES["production"]
    variables = random_variables(kw, hw)
    want = flax_to_state_dict(jax.tree.map(np.asarray, j_fold(variables)))
    got = t_fold(flax_to_state_dict(variables))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_skip_refine_returns_pre_head_prediction():
    kw, hw = CASES["production"]
    variables = random_variables(kw, hw)
    jmodel = j_build(JConfig(**kw), jnp.float32)
    f1, f2 = _frames(hw, 1)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False, skip_refine=True))(variables, f1, f2))
    got = _run_port(_port(kw, flax_to_state_dict(variables), False), f1, f2,
                    skip_refine=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_bridge_covers_the_model_and_rejects_unknown_keys():
    kw, hw = CASES["production"]
    variables = random_variables(kw, hw)
    state = flax_to_state_dict(variables)
    model = t_build(TConfig(**kw), torch.float32)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    bad = {"params": dict(variables["params"],
                          motion_unet={"kernel": np.zeros((1, 1, 1, 1))}),
           "batch_stats": variables["batch_stats"]}
    with pytest.raises(KeyError, match="motion_unet"):
        flax_to_state_dict(bad)
    bad = {"params": {"unet": {"inc": {"conv1": {"kernel": np.zeros(
        (3, 3, 2, 4)), "scale_x": np.zeros(4)}}}}}
    with pytest.raises(KeyError, match="scale_x"):
        flax_to_state_dict(bad)


def test_tower_and_flow_are_not_ported_yet():
    # the tower family, and the flow family beyond its single-field path
    for cfg in (TConfig(arch="tower"), TConfig(arch="flow", flow_bidir=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            t_build(cfg)
