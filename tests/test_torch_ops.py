"""Port host-side tensor ops vs the JAX package's on the same inputs.

The port works in NCHW and the JAX functions in NHWC: inputs are made once
with numpy and transposed for the port. Float tolerances are 1e-6 in f32
(both sides compute the same two-tap sums; only f32 rounding differs).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.models.unet import (
    depth_to_space as t_d2s, space_to_depth as t_s2d)
from ai_based_frame_interpolation_torch.ops import image as t_image
from ai_based_frame_interpolation_torch.ops import resize as t_resize
from ai_based_frame_interpolation_tpu.models.unet import (
    depth_to_space as j_d2s, space_to_depth as j_s2d)
from ai_based_frame_interpolation_tpu.ops import image as j_image
from ai_based_frame_interpolation_tpu.ops import resize as j_resize


def _nchw(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_normalize_matches_jax_on_all_uint8(dtype):
    x = np.arange(256, dtype=np.uint8).reshape(1, 16, 16, 1)
    j = np.asarray(j_image.normalize_uint8(jnp.asarray(x), getattr(jnp, dtype))
                   .astype(jnp.float32))
    t = _nhwc(t_image.normalize_uint8(_nchw(x), getattr(torch, dtype)))
    # bit for bit: the scalar 2/255 is rounded to the compute dtype first
    np.testing.assert_array_equal(t, j)


def test_denormalize_matches_jax(rng):
    x = np.concatenate([rng.uniform(-1.2, 1.2, 4000),
                        (np.arange(256) + 0.5) / 127.5 - 1.0,  # .5 ties
                        [-1.0, 1.0]]).astype(np.float32).reshape(1, 1, -1, 1)
    j = np.asarray(j_image.denormalize_to_uint8(jnp.asarray(x)))
    t = _nhwc(t_image.denormalize_to_uint8(_nchw(x))).astype(np.uint8)
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("hw", [(50, 70), (64, 64), (17, 33)])
def test_pad_and_crop_match_jax(rng, hw):
    x = rng.integers(0, 255, (2, *hw, 3), np.uint8)
    jp, jhw = j_resize.pad_to_multiple(jnp.asarray(x), 16)
    tp, thw = t_resize.pad_to_multiple(_nchw(x), 16)
    assert thw == jhw == hw
    np.testing.assert_array_equal(_nhwc(tp), np.asarray(jp, np.float32))
    np.testing.assert_array_equal(_nhwc(t_resize.crop_to(tp, thw)),
                                  x.astype(np.float32))


@pytest.mark.parametrize("c", [1, 3])
def test_space_to_depth_channel_order(rng, c):
    x = rng.standard_normal((2, 16, 24, c)).astype(np.float32)
    j = np.asarray(j_s2d(jnp.asarray(x), 4))
    t = t_s2d(_nchw(x), 4)
    np.testing.assert_array_equal(_nhwc(t), j)
    np.testing.assert_array_equal(_nhwc(t_d2s(t, 4)), x)
    np.testing.assert_array_equal(
        _nhwc(t_d2s(_nchw(j), 4)), np.asarray(j_d2s(jnp.asarray(j), 4)))
    # F.pixel_unshuffle orders channels (c, dy, dx): equal for gray only
    same = torch.equal(torch.nn.functional.pixel_unshuffle(_nchw(x), 4), t)
    assert same == (c == 1)


@pytest.mark.parametrize("hw", [(8, 12), (7, 9), (5, 1)])
@pytest.mark.parametrize("mode", ["half_pixel", "align_corners"])
def test_upsample2x_matches_jax(rng, hw, mode):
    x = rng.standard_normal((2, *hw, 3)).astype(np.float32)
    jfn = getattr(j_resize, f"upsample2x_{mode}")
    tfn = getattr(t_resize, f"upsample2x_{mode}")
    j = np.asarray(jfn(jnp.asarray(x)))
    t = _nhwc(tfn(_nchw(x)))
    assert t.shape == j.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)


def test_half_pixel_is_shift_invariant_two_tap(rng):
    # the claim of the JAX docstring: out[2i] = .25 x[i-1] + .75 x[i],
    # out[2i+1] = .75 x[i] + .25 x[i+1], edge-clamped, per axis
    x = rng.standard_normal((1, 1, 5, 7)).astype(np.float64)

    def up1(a, axis):
        n = a.shape[axis]
        lo = np.take(a, np.clip(np.arange(n) - 1, 0, n - 1), axis)
        hi = np.take(a, np.clip(np.arange(n) + 1, 0, n - 1), axis)
        even, odd = 0.25 * lo + 0.75 * a, 0.75 * a + 0.25 * hi
        return np.stack([even, odd], axis + 1).reshape(
            a.shape[:axis] + (2 * n,) + a.shape[axis + 1:])

    want = up1(up1(x, 2), 3)
    got = t_resize.upsample2x_half_pixel(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("align", [True, False])
@pytest.mark.parametrize("in_hw,out_hw", [
    ((8, 8), (16, 16)),      # the decoder's 2x
    ((7, 9), (14, 18)),      # odd sizes
    ((16, 16), (8, 8)),      # downscale
    ((5, 5), (13, 7)),       # non-integer ratio
    ((32, 24), (32, 48)),    # one axis only
])
def test_resize_bilinear_matches_jax(rng, align, in_hw, out_hw):
    # the shape pairs of tests/test_resize.py; f32, where the JAX function
    # is a per-axis lerp (its bf16 route contracts W on the MXU instead)
    x = rng.standard_normal((2, *in_hw, 3)).astype(np.float32)
    j = np.asarray(j_resize.resize_bilinear(jnp.asarray(x), out_hw,
                                            align_corners=align))
    t = _nhwc(t_resize.resize_bilinear(_nchw(x), out_hw, align_corners=align))
    assert t.shape == j.shape == (2, *out_hw, 3)
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5)
