"""The port's fused half-pixel upsample + conv (``ops/polyphase.py``) and
``UP_POLYPHASE`` vs the JAX package's, on the CPU in f32.

``up2_conv_half_pixel`` computes ``conv3x3(concat(skip, up2(low)))`` as a
low-resolution phase conv, a depth-to-space shuffle and border
corrections. Tolerances: 1e-5 against JAX's function and against the
port's own composition (f32 convs over other taps: a few ulp of values of
order 1-10); gradients 1e-4 against the composition's; a model with the
flag on 1e-4 against JAX's with its flag on (the same f32 convs summed in
another order, as ``test_torch_unet.py``) and against the lerp path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models import unet as t_unet
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.ops.polyphase import (
    up2_conv_half_pixel)
from ai_based_frame_interpolation_torch.ops.resize import (
    upsample2x_half_pixel)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models import unet as j_unet
from ai_based_frame_interpolation_tpu.ops.polyphase import (
    up2_conv_half_pixel as j_up2_conv_half_pixel)
from test_torch_unet import random_variables

# (h, w, low channels, skip channels, out channels) of the low map: every
# border and corner case at 4x6, odd sizes, a wider one
SHAPES = [(4, 6, 3, 2, 5), (5, 3, 2, 4, 3), (7, 9, 4, 4, 8), (16, 12, 4, 4, 8)]


def _inputs(h, w, cl, cs, co):
    rng = np.random.default_rng(h * 100 + w)
    low = rng.normal(size=(2, cl, h, w)).astype(np.float32)
    skip = rng.normal(size=(2, cs, 2 * h, 2 * w)).astype(np.float32)
    weight = (0.2 * rng.normal(size=(co, cs + cl, 3, 3))).astype(np.float32)
    bias = rng.normal(size=(co,)).astype(np.float32)
    return low, skip, weight, bias


def _composed(low, skip, weight, bias):
    return F.conv2d(torch.cat([skip, upsample2x_half_pixel(low)], 1), weight,
                    bias, padding=1)


@pytest.fixture(scope="module")
def jax_fused():
    """JAX's fused op at every shape, in one compiled call (NCHW out)."""
    args = [_inputs(*shape) for shape in SHAPES]

    def run(all_args):
        return [j_up2_conv_half_pixel(
            low.transpose(0, 2, 3, 1), skip.transpose(0, 2, 3, 1),
            weight.transpose(2, 3, 1, 0), bias,
            compute_dtype=jnp.float32).transpose(0, 3, 1, 2)
            for low, skip, weight, bias in all_args]

    return [np.asarray(o) for o in jax.jit(run)(args)]


@pytest.mark.parametrize("i", range(len(SHAPES)),
                         ids=["x".join(map(str, s)) for s in SHAPES])
def test_fused_matches_jax_and_the_composition(i, jax_fused):
    args = [torch.from_numpy(a) for a in _inputs(*SHAPES[i])]
    got = up2_conv_half_pixel(*args, compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), jax_fused[i], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), _composed(*args).numpy(),
                               rtol=0, atol=1e-5)


def test_gradients_match_the_composition():
    low, skip, weight, bias = (torch.from_numpy(a).requires_grad_()
                               for a in _inputs(*SHAPES[0]))
    cot = torch.from_numpy(np.random.default_rng(3).normal(
        size=(2, 5, 8, 12)).astype(np.float32))
    grads = []
    for fn in (lambda *a: up2_conv_half_pixel(*a, torch.float32),
               _composed):
        grads.append(torch.autograd.grad(fn(low, skip, weight, bias), (
            low, skip, weight, bias), cot))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-4)


def test_unet_with_up_polyphase_matches_jax(monkeypatch):
    # the half-pixel production shape at a tiny width, unfolded (the fused
    # conv then has no bias): the same params and state_dict keys under
    # either flag
    kw = dict(base_width=8, depth=2, space_to_depth=2, residual=True,
              refine_width=8, upsample="half_pixel")
    hw = (32, 48)
    variables = random_variables(kw, hw)
    rng = np.random.default_rng(4)
    f1, f2 = (rng.uniform(-1, 1, (2, *hw, 1)).astype(np.float32)
              for _ in range(2))
    monkeypatch.setattr(j_unet, "UP_POLYPHASE", True)
    jmodel = j_build(JConfig(**kw), jnp.float32)
    want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, train=False))(variables, f1, f2))
    model = t_build(TConfig(**kw), torch.float32)
    model.load_state_dict(flax_to_state_dict(variables))
    x1, x2 = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
              for a in (f1, f2))
    with torch.inference_mode():
        lerp = model.eval()(x1, x2)
        monkeypatch.setattr(t_unet, "UP_POLYPHASE", True)
        calls = []
        monkeypatch.setattr(t_unet, "up2_conv_half_pixel",
                            lambda *a: calls.append(1) or
                            up2_conv_half_pixel(*a))
        got = model(x1, x2)
    assert len(calls) == 2                     # up1 and up2
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), lerp.numpy(), rtol=0, atol=1e-4)
