"""The port's PSNR and SSIM vs the JAX package, on the CPU.

Tolerances:

- the plain ``psnr``/``ssim_eval`` and the Gaussian training SSIM against
  JAX's XLA functions: 1e-5. Both compute in f32; the port applies each
  separable window as shifted multiply-adds where JAX calls a depthwise
  convolution, which sums in another order (measured: a few 1e-7);
- the plain ``ssim_eval`` against the Pallas kernels in interpret mode:
  2e-4, the JAX package's own cross-route bound (``test_pallas_ssim.py``):
  the kernel takes exact window sums and divides once, the plain version
  weights by 1/7 in two passes, and the variance terms cancel.

The CUDA kernel itself is held against the plain version on the card by
the ``cuda`` test below and by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.ops import ssim as t_ssim
from ai_based_frame_interpolation_torch.ops.psnr import psnr as t_psnr
from ai_based_frame_interpolation_torch.ops.ssim_fused import (
    ssim_eval_auto, ssim_eval_fused, ssim_eval_tiled)
from ai_based_frame_interpolation_tpu.ops import ssim as j_ssim
from ai_based_frame_interpolation_tpu.ops.pallas.ssim_fused import (
    ssim_eval_fused as j_fused, ssim_eval_tiled as j_tiled)
from ai_based_frame_interpolation_tpu.ops.psnr import psnr as j_psnr

SSIM_BOUND = 2e-4


def _pair(shape, dtype=np.uint8, seed=0):
    gen = np.random.default_rng(seed)
    a = gen.integers(0, 256, shape)
    b = np.clip(a + gen.integers(-30, 31, shape), 0, 255)
    if dtype == np.float32:
        return (a / 255.0).astype(np.float32), (b / 255.0).astype(np.float32)
    return a.astype(dtype), b.astype(dtype)


def _both(fn_t, fn_j, a, b, **kw):
    got = fn_t(torch.from_numpy(a), torch.from_numpy(b), **kw).numpy()
    want = np.asarray(fn_j(jnp.asarray(a), jnp.asarray(b), **kw))
    return got, want


@pytest.mark.parametrize("shape,dtype,data_range", [
    ((3, 24, 32, 1), np.uint8, 255.0),
    ((2, 20, 18, 1), np.float32, 1.0),
    ((2, 16, 24, 3), np.uint8, 255.0),     # RGB: mean over the channels
    ((20, 24, 1), np.uint8, 255.0),        # unbatched -> a scalar
])
def test_psnr_and_ssim_eval_match_jax(shape, dtype, data_range):
    a, b = _pair(shape, dtype)
    for fn_t, fn_j in ((t_psnr, j_psnr), (t_ssim.ssim_eval, j_ssim.ssim_eval)):
        got, want = _both(fn_t, fn_j, a, b, data_range=data_range)
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_ssim_eval_smaller_than_the_window_is_nan():
    a, b = _pair((2, 6, 20, 1))
    got, want = _both(t_ssim.ssim_eval, j_ssim.ssim_eval, a, b)
    assert np.isnan(want).all() and np.isnan(got).all()
    assert np.isnan(ssim_eval_auto(torch.from_numpy(a),
                                   torch.from_numpy(b)).numpy()).all()


@pytest.mark.parametrize("route,shape", [(j_fused, (2, 24, 32, 1)),
                                         (j_tiled, (1, 75, 40, 1))])
def test_plain_ssim_eval_matches_the_pallas_kernels(route, shape):
    a, b = _pair(shape, seed=1)
    want = np.asarray(route(jnp.asarray(a[..., 0]), jnp.asarray(b[..., 0]),
                            interpret=True))
    got = t_ssim.ssim_eval(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=SSIM_BOUND)


@pytest.mark.parametrize("name", ["ssim_loss_map", "ssim", "ssim_loss",
                                  "combined_loss"])
def test_gaussian_ssim_matches_jax(name):
    gen = np.random.default_rng(2)
    a = gen.uniform(-1, 1, (2, 20, 24, 1)).astype(np.float32)
    b = np.clip(a + gen.normal(0, 0.2, a.shape), -1, 1).astype(np.float32)
    got, want = _both(getattr(t_ssim, name), getattr(j_ssim, name), a, b)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("fn", [ssim_eval_fused, ssim_eval_tiled,
                                ssim_eval_auto])
def test_kernel_entry_points_take_the_plain_version_on_cpu(fn):
    a, b = _pair((2, 24, 32, 1), seed=3)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    before = ssim_eval_fused.launches
    got = fn(ta, tb)
    assert ssim_eval_fused.launches == before
    assert torch.equal(got, t_ssim.ssim_eval(ta, tb))
    if fn is not ssim_eval_auto:     # the JAX kernels' [B,H,W] form
        assert torch.equal(fn(ta[..., 0], tb[..., 0]), got)
    else:                            # ssim_eval's unbatched [H,W,C] form
        assert torch.equal(fn(ta[0], tb[0]), got[0])


def test_kernel_entry_points_refuse_other_devices():
    a = torch.zeros((1, 8, 8, 1), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ssim_eval_auto(a, a)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the ssim_eval kernel is CUDA only")
    for shape in ((2, 70, 16, 1), (2, 33, 45, 3), (1, 7, 7, 1)):
        a, b = (torch.from_numpy(x).cuda() for x in _pair(shape, seed=4))
        before = ssim_eval_fused.launches
        got = ssim_eval_auto(a, b)
        assert ssim_eval_fused.launches == before + 1
        want = t_ssim.ssim_eval(a, b)
        assert float((got - want).abs().max()) <= SSIM_BOUND
        assert torch.equal(ssim_eval_auto(a, b), got)       # deterministic
    assert float(ssim_eval_auto(a, a).min()) == 1.0
