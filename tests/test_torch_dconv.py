"""The port's plain double conv and up block vs the JAX package's.

``double_conv_reference`` and ``up_double_conv_reference`` are held against
JAX's XLA double conv (``ops/pallas/dconv_fused.py:double_conv_reference``)
and against the Pallas kernels in interpret mode, once each at a small
shape, as ``tests/test_dconv_fused.py`` runs them on the CPU. Weights and
inputs come from numpy. Tolerances:

- bf16 against XLA and the kernels: both sides round each conv to bf16
  before and after its bias, but the f32 sums run in another order, so a
  sum near a rounding boundary can land one bf16 ulp apart and carry into
  the next conv: within 2 ulp (rtol 2^-6, atol 0.032) and bit for bit on at
  least 95% of the values;
- the up block against the composed XLA path (``upsample2x_half_pixel``,
  which rounds once where the kernel rounds after each axis): JAX's own
  bound for that pair, atol 0.25 and rtol 0.05;
- f32: 1e-4 for the same f32 sums in another order; 1e-6 for the upsample.

The kernels themselves run only on the card: the ``cuda`` test below and
``chip_smoke.py`` hold them against these plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.ops.dconv_fused import (
    check_packed, double_conv_fused, double_conv_reference,
    pack_dconv_weights, up_double_conv_fused, up_double_conv_reference,
    upsample2x_half_pixel_nhwc)
from ai_based_frame_interpolation_torch.ops.resize import (
    upsample2x_half_pixel)
from ai_based_frame_interpolation_tpu.ops.pallas import dconv_fused as jdc
from ai_based_frame_interpolation_tpu.ops.resize import (
    upsample2x_half_pixel as j_upsample2x_half_pixel)

CPU = jax.devices("cpu")[0]


def _weights(cin, mid, cout, seed=0):
    """Flax HWIO conv weights and biases, drawn from numpy, scaled so the
    activations stay of order 1."""
    gen = np.random.default_rng(seed)
    w1 = (gen.standard_normal((3, 3, cin, mid)) / np.sqrt(9 * cin)) \
        .astype(np.float32)
    w2 = (gen.standard_normal((3, 3, mid, cout)) / np.sqrt(9 * mid)) \
        .astype(np.float32)
    b1 = (0.1 * gen.standard_normal(mid)).astype(np.float32)
    b2 = (0.1 * gen.standard_normal(cout)).astype(np.float32)
    return w1, b1, w2, b2


def _torch_weights(w1, b1, w2, b2):
    """HWIO -> the port's [out, in, 3, 3]."""
    t = lambda w: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        w.transpose(3, 2, 0, 1)))
    return t(w1), torch.from_numpy(b1), t(w2), torch.from_numpy(b2)


def _x(shape, seed=1):
    return np.random.default_rng(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _bf16_close(got, want, share=0.95):
    np.testing.assert_allclose(got, want, rtol=2 ** -6, atol=0.032)
    assert float((got == want).mean()) >= share


def _to_rowmajor(x, wp):
    """[B,H,W,C] -> the Pallas kernels' [B,H,C,W] with zero lane padding."""
    xt = jnp.transpose(x, (0, 1, 3, 2))
    return jnp.pad(xt, ((0, 0), (0, 0), (0, 0), (0, wp - xt.shape[-1])))


# (batch, height, width, cin, mid, cout): odd H and W, uneven channels
DC_SHAPES = [(2, 16, 24, 8, 16, 8), (1, 13, 21, 24, 40, 8),
             (1, 7, 9, 32, 8, 16)]


@pytest.mark.parametrize("b,h,w,cin,mid,cout", DC_SHAPES)
def test_double_conv_reference_matches_jax_xla(b, h, w, cin, mid, cout):
    wts = _weights(cin, mid, cout)
    x = _x((b, h, w, cin))
    with jax.default_device(CPU):
        want = np.asarray(jdc.double_conv_reference(
            jnp.asarray(x, jnp.bfloat16), *wts), np.float32)
    got = double_conv_reference(torch.from_numpy(x), *_torch_weights(*wts))
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, cout)
    assert got.is_contiguous()
    _bf16_close(got.float().numpy(), want)


def test_double_conv_reference_matches_jax_xla_f32():
    b, h, w, cin, mid, cout = DC_SHAPES[1]
    wts = _weights(cin, mid, cout)
    x = _x((b, h, w, cin))
    with jax.default_device(CPU):
        want = np.asarray(jdc.double_conv_reference(
            jnp.asarray(x), *wts, compute_dtype=jnp.float32))
    got = double_conv_reference(torch.from_numpy(x), *_torch_weights(*wts),
                                compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)


def test_double_conv_reference_matches_pallas_interpret():
    b, h, w, cin, mid, cout = 1, 8, 24, 8, 16, 8
    wts = _weights(cin, mid, cout, seed=2)
    x = _x((b, h, w, cin), seed=3)
    with jax.default_device(CPU):
        xb = jnp.asarray(x, jnp.bfloat16)
        assert jdc.eligible(_to_rowmajor(xb, 128).shape)
        got_t = jdc.double_conv_fused(_to_rowmajor(xb, 128), *wts,
                                      image_width=w, interpret=True)
        want = np.asarray(jnp.transpose(got_t[..., :w], (0, 1, 3, 2)),
                          np.float32)
    got = double_conv_reference(torch.from_numpy(x), *_torch_weights(*wts))
    _bf16_close(got.float().numpy(), want)


def _up_inputs(b, h, w, cs, cu, seed=4):
    return _x((b, h, w, cs), seed), _x((b, h // 2, w // 2, cu), seed + 1)


def test_up_reference_matches_pallas_interpret():
    """The plain up block keeps the Pallas kernel's rounding points (each
    upsample axis rounded to bf16): within 2 ulp of the kernel."""
    b, h, w, cs, cu, mid, cout = 1, 16, 48, 8, 8, 8, 8
    wts = _weights(cs + cu, mid, cout, seed=5)
    skip, low = _up_inputs(b, h, w, cs, cu)
    with jax.default_device(CPU):
        sb, lb = jnp.asarray(skip, jnp.bfloat16), jnp.asarray(low, jnp.bfloat16)
        got_t = jdc.up_double_conv_fused(
            _to_rowmajor(sb, 128), _to_rowmajor(lb, 64), *wts, image_width=w,
            interpret=True)
        want = np.asarray(jnp.transpose(got_t[..., :w], (0, 1, 3, 2)),
                          np.float32)
    got = up_double_conv_reference(torch.from_numpy(skip),
                                   torch.from_numpy(low), *_torch_weights(*wts))
    assert tuple(got.shape) == (b, h, w, cout)
    _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("b,h,w,cs,cu,mid,cout", [(2, 16, 40, 16, 8, 16, 8),
                                                  (1, 10, 14, 8, 24, 16, 8)])
def test_up_reference_matches_composed_xla(b, h, w, cs, cu, mid, cout):
    wts = _weights(cs + cu, mid, cout, seed=6)
    skip, low = _up_inputs(b, h, w, cs, cu, seed=7)
    with jax.default_device(CPU):
        sb, lb = jnp.asarray(skip, jnp.bfloat16), jnp.asarray(low, jnp.bfloat16)
        up = j_upsample2x_half_pixel(lb).astype(jnp.bfloat16)
        want = np.asarray(jdc.double_conv_reference(
            jnp.concatenate([sb, up], -1), *wts), np.float32)
    got = up_double_conv_reference(torch.from_numpy(skip),
                                   torch.from_numpy(low), *_torch_weights(*wts))
    np.testing.assert_allclose(got.float().numpy(), want, atol=0.25,
                               rtol=0.05)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample_nhwc_is_the_half_pixel_grid(dtype):
    """The two-pass upsample is ``F.interpolate``'s half-pixel grid: equal
    within f32 rounding in f32; in bf16, where it rounds after each axis,
    within one bf16 ulp of the inputs' scale (2^-8 for inputs in [-1, 1])."""
    low = torch.from_numpy(_x((2, 5, 7, 8), seed=8)).to(dtype)
    got = upsample2x_half_pixel_nhwc(low).float()
    want = upsample2x_half_pixel(low.permute(0, 3, 1, 2)) \
        .permute(0, 2, 3, 1).float()
    assert tuple(got.shape) == (2, 10, 14, 8)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -8
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=tol)


def _unchunk(flat, n_total, k_ch):
    """The chunk stream back as [9][n_total][k_ch], each chunk found where
    ``csrc/double_conv.cu``'s ``Stream::chunk`` computes it (N pass p,
    tap, K chunk j of a 64x64 grid; rows of kw + 8, the last 8 zero)."""
    kch = (k_ch + 63) // 64
    row = k_ch + 8 * kch
    out = torch.zeros(9, n_total, k_ch)
    for q in range((n_total + 63) // 64 * 9 * kch):
        p, tap, j = q // (9 * kch), q % (9 * kch) // kch, q % kch
        nw, kw = min(64, n_total - 64 * p), min(64, k_ch - 64 * j)
        off = (p * 64 * 9 + tap * nw) * row + nw * j * 72
        block = flat[off:off + nw * (kw + 8)].reshape(nw, kw + 8)
        assert not block[:, kw:].any()
        out[tap, 64 * p:64 * p + nw, 64 * j:64 * j + kw] = block[:, :kw]
    assert flat.numel() == 9 * n_total * row
    return out


@pytest.mark.parametrize("split", [None, 8, 24])
def test_packed_weights_are_the_kernel_layout(split):
    """The layouts a model packs once (``pack_dconv_weights``) are what the
    kernel reads: w1 as (tap, out, in) over the input padded per part to
    16 channels and w2 as (tap, out, in) over mid padded to 16, each stored
    as the chunk stream the kernel's bulk copies take (read back here as
    the kernel locates each chunk). The double conv computed from them
    gives the plain version, in f32."""
    _check_layout(split, 32, 24)


def test_packed_weights_span_n_passes_and_k_chunks():
    """The same where the streams hold two N passes and two K chunks (72
    inputs, 80 mid channels): a last pass of 16 rows, a last chunk of 8."""
    _check_layout(None, 72, 80)


def _check_layout(split, cin, mid):
    cout = 8
    wts = [w.bfloat16().float() for w in _torch_weights(
        *_weights(cin, mid, cout, seed=9))]       # exact in bf16
    x = torch.from_numpy(_x((1, 6, 10, cin), seed=10))
    packed = pack_dconv_weights(*wts, split=split)
    assert packed["w1"].dtype == torch.bfloat16 and packed["w1"].dim() == 1
    parts = [(0, cin)] if split is None else [(0, split), (split, cin)]
    kin = sum((hi - lo + 15) // 16 * 16 for lo, hi in parts)
    midp = (mid + 15) // 16 * 16
    kw = {"w1": _unchunk(packed["w1"].float(), midp, kin),
          "w2": _unchunk(packed["w2"].float(), 16, midp),
          "b1": packed["b1"].float(), "b2": packed["b2"].float()}
    assert tuple(kw["b1"].shape) == (midp,) and tuple(kw["b2"].shape) == (16,)

    def pad_parts(z):                 # the kernel's shared-memory pixel row
        return torch.cat([torch.nn.functional.pad(
            z[..., lo:hi], (0, (hi - lo + 15) // 16 * 16 - (hi - lo)))
            for lo, hi in parts], -1)

    def conv(z, w, b):                # SAME 3x3 over (tap, out, in) weights
        zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
        h, wd = z.shape[1:3]
        t = torch.stack([zp[:, dy:dy + h, dx:dx + wd]
                         for dy in range(3) for dx in range(3)], 3)
        return torch.relu(torch.einsum("bhwtk,tok->bhwo", t, w) + b)

    z1 = conv(pad_parts(x), kw["w1"], kw["b1"])
    full = conv(z1, kw["w2"], kw["b2"])
    assert not z1[..., mid:].any() and not full[..., cout:].any()
    want = double_conv_reference(x, *wts, compute_dtype=torch.float32)
    np.testing.assert_allclose(full[..., :cout].numpy(), want.numpy(),
                               rtol=0, atol=1e-4)


def test_check_packed_refuses_what_the_kernel_cannot_read():
    """The kernel reads only weights packed once for its own split, as the
    chunk stream: none, another split, another width, the (tap, out, in)
    tensors unchunked, or the f32 route's layout is refused before a
    launch."""
    w1, b1, w2, b2 = _torch_weights(*_weights(32, 24, 8, seed=16))
    check_packed(pack_dconv_weights(w1, b1, w2, b2, split=8), w1, w2, 8, 24, 8)
    check_packed(pack_dconv_weights(w1, b1, w2, b2), w1, w2, 32, 0, None)
    with pytest.raises(ValueError, match="packed once"):
        check_packed(None, w1, w2, 32, 0, None)
    with pytest.raises(ValueError, match="do not match"):
        check_packed(pack_dconv_weights(w1, b1, w2, b2, split=8), w1, w2,
                     32, 0, None)
    with pytest.raises(ValueError, match="do not match"):
        check_packed(pack_dconv_weights(w1, b1, w2, b2), w1, w2, 8, 24, 8)
    w1n, b1n, w2n, b2n = _torch_weights(*_weights(32, 40, 8, seed=17))
    with pytest.raises(ValueError, match="do not match"):
        check_packed(pack_dconv_weights(w1n, b1n, w2n, b2n), w1, w2, 32, 0,
                     None)
    packed = pack_dconv_weights(w1, b1, w2, b2)
    unchunked = dict(packed, w1=_unchunk(packed["w1"].float(), 32, 32)
                     .bfloat16(), w2=_unchunk(packed["w2"].float(), 16, 32)
                     .bfloat16())
    with pytest.raises(ValueError, match="do not match"):
        check_packed(unchunked, w1, w2, 32, 0, None)
    with pytest.raises(ValueError, match="do not match"):
        check_packed(pack_dconv_weights(w1, b1, w2, b2,
                                        compute_dtype=torch.float32),
                     w1, w2, 32, 0, None)


def test_cpu_wrappers_run_the_plain_versions_without_launching():
    wts = _torch_weights(*_weights(16, 8, 8, seed=11))
    x = torch.from_numpy(_x((1, 8, 12, 16), seed=12))
    skip, low = (torch.from_numpy(a) for a in _up_inputs(1, 8, 12, 8, 8))
    def counts():
        return (double_conv_fused.launches, up_double_conv_fused.launches,
                dict(double_conv_fused.routes),
                dict(up_double_conv_fused.routes))

    before = counts()
    assert torch.equal(double_conv_fused(x, *wts),
                       double_conv_reference(x, *wts))
    assert torch.equal(up_double_conv_fused(skip, low, *wts),
                       up_double_conv_reference(skip, low, *wts))
    assert counts() == before


@pytest.mark.cuda
def test_kernels_match_plain_on_the_card():
    """On the card (skips here): each kernel within 2 bf16 ulp of its plain
    version, with a launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    wts = [w.cuda() for w in _torch_weights(*_weights(24, 40, 8, seed=13))]
    x = torch.from_numpy(_x((2, 19, 37, 24), seed=14)).cuda()
    n = (double_conv_fused.launches, double_conv_fused.routes["fused"])
    got = double_conv_fused(x, *wts, packed=pack_dconv_weights(*wts))
    assert (double_conv_fused.launches,
            double_conv_fused.routes["fused"]) == (n[0] + 1, n[1] + 1)
    _bf16_close(got.float().cpu().numpy(),
                double_conv_reference(x, *wts).float().cpu().numpy())
    wts = [w.cuda() for w in _torch_weights(*_weights(24, 16, 8, seed=15))]
    skip, low = (torch.from_numpy(a).cuda()
                 for a in _up_inputs(2, 18, 34, 16, 8))
    n = up_double_conv_fused.launches
    got = up_double_conv_fused(skip, low, *wts,
                               packed=pack_dconv_weights(*wts, split=16))
    assert up_double_conv_fused.launches == n + 1
    _bf16_close(got.float().cpu().numpy(),
                up_double_conv_reference(skip, low, *wts).float().cpu()
                .numpy())
