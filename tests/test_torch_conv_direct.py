"""The direct-conv routes (``ops/conv_direct.py``) vs the JAX package.

The plain versions of the direct convs, composed as the f32 and wide-head
routes compose the kernels, are held against the JAX package's XLA
functions at small shapes: the double conv (``ops/pallas/dconv_fused.py:
double_conv_reference``), the up block through the composed XLA path, and a
depthwise 3x3 (``lax.conv_general_dilated`` with one group per channel, as
Flax emits the head's ``refine2_dw``). Weights and inputs come from numpy.
Tolerances:

- f32: atol 1e-5, the same f32 sums in another order (the up block 1e-5
  as well: in f32 both upsamples round each product and sum once);
- bf16: each conv rounded to bf16 before and after its bias, the f32 sums
  in another order: within one bf16 ulp of the value's magnitude;
- engines: within 1 uint8 LSB, the repo's cross-program tolerance.

The kernels themselves run only on the card: the ``cuda`` tests below and
``chip_smoke.py`` hold them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.ops.conv_direct import (
    conv_direct, conv_direct_reference, head_out_direct, head_out_reference,
    pack_conv)
from ai_based_frame_interpolation_torch.ops.dconv_fused import (
    check_packed, dconv_route, double_conv_reference, pack_dconv_weights,
    up_double_conv_reference)
from ai_based_frame_interpolation_tpu.ops.pallas import dconv_fused as jdc
from ai_based_frame_interpolation_tpu.ops.resize import (
    upsample2x_half_pixel as j_upsample2x_half_pixel)

CPU = jax.devices("cpu")[0]


def _x(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _hwio(cin, cout, seed, k=3):
    gen = np.random.default_rng(seed)
    w = (gen.standard_normal((k, k, cin, cout)) / np.sqrt(k * k * cin)) \
        .astype(np.float32)
    return w, (0.1 * gen.standard_normal(cout)).astype(np.float32)


def _oihw(w):
    return torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))


def _within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp at the larger magnitude, elementwise."""
    got, want = got.astype(np.float64), want.astype(np.float64)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.exp2(np.floor(np.log2(np.maximum(mag, 2.0 ** -126))) - 7)
    assert bool(np.all(np.abs(got - want) <= ulp)), \
        float(np.max(np.abs(got - want) / ulp))


def _direct_double_conv(x, wts, dtype, low=None):
    """The f32 route's composition: two direct convs, the first over
    concat(x, up2(low)) when ``low`` is given."""
    p1, p2 = pack_conv(*wts[:2], dtype), pack_conv(*wts[2:], dtype)
    z1 = conv_direct(x.to(dtype), p1["w"], p1["b"],
                     None if low is None else low.to(dtype))
    return conv_direct(z1, p2["w"], p2["b"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_double_conv_matches_jax_xla(dtype):
    """The route's two direct convs against JAX's XLA double conv
    (``double_conv_reference``), 1x13x21, 24 -> 40 -> 8 channels."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    x = _x((1, 13, 21, 24))
    (w1, b1), (w2, b2) = _hwio(24, 40, seed=2), _hwio(40, 8, seed=3)
    wts = (_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2))
    with jax.default_device(CPU):
        want = np.asarray(jdc.double_conv_reference(
            jnp.asarray(x, jdt), w1, b1, w2, b2, compute_dtype=jdt),
            np.float32)
    got = _direct_double_conv(torch.from_numpy(x), wts, tdt)
    assert got.dtype == tdt and tuple(got.shape) == (1, 13, 21, 8)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    else:
        _within_one_ulp(got.float().numpy(), want)


def test_direct_up_block_matches_composed_xla_f32():
    """The f32 up block's route (the first direct conv reading up2(low))
    against JAX's composed XLA path: upsample, concat, double conv."""
    skip, low = _x((2, 10, 14, 8), seed=4), _x((2, 5, 7, 16), seed=5)
    (w1, b1), (w2, b2) = _hwio(24, 16, seed=6), _hwio(16, 8, seed=7)
    wts = (_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2))
    with jax.default_device(CPU):
        up = j_upsample2x_half_pixel(jnp.asarray(low))
        want = np.asarray(jdc.double_conv_reference(
            jnp.concatenate([jnp.asarray(skip), up], -1), w1, b1, w2, b2,
            compute_dtype=jnp.float32))
    got = _direct_double_conv(torch.from_numpy(skip), wts, torch.float32,
                              torch.from_numpy(low))
    assert tuple(got.shape) == (2, 10, 14, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), up_double_conv_reference(
            torch.from_numpy(skip), torch.from_numpy(low), *wts,
            compute_dtype=torch.float32).numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_direct_depthwise_matches_jax_xla(dtype):
    """The depthwise mode (no ReLU) against XLA's grouped conv."""
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    c = 16
    x = _x((1, 12, 18, c), seed=8)
    gen = np.random.default_rng(9)
    w = (gen.standard_normal((3, 3, 1, c)) / 3.0).astype(np.float32)
    b = (0.1 * gen.standard_normal(c)).astype(np.float32)
    with jax.default_device(CPU):
        want = np.asarray(jax.lax.conv_general_dilated(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt), (1, 1), "SAME",
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
            feature_group_count=c) + jnp.asarray(b, jdt), np.float32)
    p = pack_conv(_oihw(w), torch.from_numpy(b), tdt, depthwise=True)
    assert tuple(p["w"].shape) == (9, c)
    got = conv_direct(torch.from_numpy(x).to(tdt), p["w"], p["b"],
                      relu=False, depthwise=True).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        _within_one_ulp(got, want)


def test_head_out_is_the_f32_out_conv_and_residual():
    z = torch.from_numpy(_x((1, 4, 6, 96), seed=10)).bfloat16()
    w3 = torch.from_numpy(_x((96, 3), seed=11))
    b3, pred = torch.from_numpy(_x((3,), 12)), torch.from_numpy(
        _x((1, 4, 6, 3), 13))
    want = (pred + torch.einsum("bhwk,kc->bhwc", z.float(), w3) + b3) \
        .bfloat16()
    got = head_out_direct(z, w3, b3, pred)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=2 ** -7)
    assert torch.equal(got, head_out_reference(z, w3, b3, pred))


def test_dconv_route_and_f32_packing():
    """bf16 takes the fused kernel, f32 the direct convs (each packed as
    ``pack_conv`` packs it); another dtype raises."""
    assert dconv_route(torch.bfloat16) == "fused"
    assert dconv_route(torch.float32) == "direct"
    with pytest.raises(ValueError, match="bf16 or f32"):
        dconv_route(torch.float16)
    (w1, b1), (w2, b2) = _hwio(16, 24, seed=14), _hwio(24, 8, seed=15)
    wts = (_oihw(w1), torch.from_numpy(b1), _oihw(w2), torch.from_numpy(b2))
    packed = pack_dconv_weights(*wts, split=8, compute_dtype=torch.float32)
    assert tuple(packed["w1"].shape) == (9, 16, 24)
    assert torch.equal(packed["w2"], pack_conv(*wts[2:], torch.float32)["w"])
    check_packed(packed, wts[0], wts[2], 8, 8, 8, torch.float32)
    with pytest.raises(ValueError, match="do not match"):
        check_packed(packed, wts[0], wts[2], 8, 8, 8)          # bf16 layout
    with pytest.raises(ValueError, match="do not match"):
        check_packed(pack_dconv_weights(*wts, split=8), wts[0], wts[2], 8,
                     8, 8, torch.float32)


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    x = torch.from_numpy(_x((1, 6, 8, 8), seed=16))
    w, b = _hwio(8, 8, seed=17)
    p = pack_conv(_oihw(w), torch.from_numpy(b), torch.float32)
    before = (conv_direct.launches, head_out_direct.launches)
    assert torch.equal(conv_direct(x, p["w"], p["b"]),
                       conv_direct_reference(x, p["w"], p["b"]))
    head_out_direct(x, torch.ones(8, 1), torch.zeros(1), x[..., :1])
    assert (conv_direct.launches, head_out_direct.launches) == before


def test_f32_engine_on_the_option_core_matches_jax():
    """The f32 engine with ``core_impl="pallas"`` and a width-32 head (on
    the card: the direct convs for the core and the head) within 1 LSB of
    the JAX engine in f32, at ``tests/test_torch_core.py``'s size; its
    packed weights are the f32 route's."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_tpu.config import ModelConfig as JConf
    from ai_based_frame_interpolation_tpu.infer.engine import (
        InterpolationEngine as JEngine)
    from ai_based_frame_interpolation_tpu.models import build_model as j_build
    from ai_based_frame_interpolation_tpu.models.unet import (
        fold_batchnorm as j_fold)
    from test_torch_unet import random_variables

    kw = dict(space_to_depth=2, base_width=8, refine_width=32, residual=True,
              upsample="half_pixel")
    variables = jax.tree.map(np.asarray, j_fold(random_variables(
        kw, (64, 64), seed=3)))
    jeng = JEngine(j_build(JConf(**kw), jnp.float32, folded=True), variables,
                   compute_dtype=jnp.float32)
    teng = InterpolationEngine.from_flax_variables(
        variables, ModelConfig(**kw), compute_dtype=torch.float32,
        device="cpu", core_impl="pallas")
    assert tuple(teng.model.packed_head["w1"].shape) == (9, 3, 32)
    assert teng.model.packed_core["inc"]["w1"].dim() == 3
    gen = np.random.default_rng(8)
    f1 = gen.integers(0, 256, (1, 64, 1024, 1), dtype=np.uint8)
    f2 = np.roll(f1, 3, axis=2)
    got, want = teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1


@pytest.mark.cuda
def test_direct_convs_match_plain_on_the_card():
    """On the card (skips here): the direct kernel in f32 (dense, the up
    block's first conv, depthwise, 1x1; the tiles for 16, 32 and 64 output
    channels, channel counts that are not multiples of 4, depthwise over
    two channel blocks) within 1e-4 of its plain version with TF32 off, in
    bf16 within one ulp at the output's magnitude; the out kernel;
    launches counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        x = torch.from_numpy(_x((2, 19, 37, 24), seed=18)).cuda()
        skip = torch.from_numpy(_x((2, 18, 36, 24), seed=19)).cuda()
        low = torch.from_numpy(_x((2, 9, 18, 8), seed=19)).cuda()
        gen = np.random.default_rng(20)
        wdw = (gen.standard_normal((3, 3, 1, 24)) / 3.0).astype(np.float32)
        x5 = torch.from_numpy(_x((2, 19, 37, 5), seed=27)).cuda()
        x72 = torch.from_numpy(_x((1, 21, 40, 72), seed=28)).cuda()
        wdw72 = (gen.standard_normal((3, 3, 1, 72)) / 3.0).astype(np.float32)
        cases = [(x, None, _hwio(24, 40, 20), {}),
                 (skip, low, _hwio(32, 16, 20), {}),
                 (x, None, (wdw, _hwio(24, 24, 20)[1]),
                  {"depthwise": True, "relu": False}),
                 (x, None, _hwio(24, 40, 20, k=1), {}),
                 (x5, None, _hwio(5, 6, 29), {}),
                 (x, None, _hwio(24, 20, 30), {}),
                 (x72, None, (wdw72, _hwio(72, 72, 31)[1]),
                  {"depthwise": True, "relu": False}),
                 (x, None, _hwio(24, 36, 32, k=1), {})]
        for dt in (torch.float32, torch.bfloat16):
            for xi, lo, (w, b), kw in cases:
                p = pack_conv(_oihw(w), torch.from_numpy(b), dt,
                              depthwise=kw.get("depthwise", False))
                args = (xi.to(dt), p["w"].cuda(), p["b"].cuda(),
                        None if lo is None else lo.to(dt))
                n = conv_direct.launches
                got = conv_direct(*args, **kw)
                assert conv_direct.launches == n + 1
                want = conv_direct_reference(*args, **kw)
                err = float((got.float() - want.float()).abs().max())
                mag = float(want.float().abs().max())
                assert err <= (1e-4 if dt == torch.float32 else
                               2.0 ** (np.floor(np.log2(mag)) - 7)), err
        z = torch.from_numpy(_x((2, 8, 8, 96), seed=21)).cuda()
        w3 = torch.from_numpy(_x((96, 1), seed=22)).cuda()
        b3, pred = torch.zeros(1).cuda(), z[..., :1].contiguous()
        n = head_out_direct.launches
        got = head_out_direct(z, w3, b3, pred)
        assert head_out_direct.launches == n + 1
        assert float((got - head_out_reference(z, w3, b3, pred)).abs()
                     .max()) <= 1e-4
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = tf32


@pytest.mark.cuda
def test_f32_double_conv_routes_on_the_card():
    """On the card (skips here): the f32 double conv and up block take two
    direct-conv launches each and no fused launch, within 1e-4 of plain."""
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, up_double_conv_fused)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    f32 = torch.float32
    (w1, b1), (w2, b2) = _hwio(24, 16, seed=23), _hwio(16, 8, seed=24)
    wts = [t.cuda() for t in (_oihw(w1), torch.from_numpy(b1), _oihw(w2),
                              torch.from_numpy(b2))]
    skip = torch.from_numpy(_x((2, 18, 34, 16), seed=25)).cuda()
    low = torch.from_numpy(_x((2, 9, 17, 8), seed=26)).cuda()
    x = torch.cat([skip, skip[..., :8]], -1)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        n = (conv_direct.launches, double_conv_fused.launches,
             up_double_conv_fused.launches,
             double_conv_fused.routes["direct"],
             up_double_conv_fused.routes["direct"])
        got = double_conv_fused(x, *wts, f32, pack_dconv_weights(
            *wts, compute_dtype=f32))
        got_up = up_double_conv_fused(skip, low, *wts, f32, pack_dconv_weights(
            *wts, split=16, compute_dtype=f32))
        assert (conv_direct.launches, double_conv_fused.launches,
                up_double_conv_fused.launches,
                double_conv_fused.routes["direct"],
                up_double_conv_fused.routes["direct"]) == (
            n[0] + 4, n[1], n[2], n[3] + 2, n[4] + 2)
        assert float((got - double_conv_reference(x, *wts, f32)).abs()
                     .max()) <= 1e-4
        assert float((got_up - up_double_conv_reference(
            skip, low, *wts, f32)).abs().max()) <= 1e-4
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
