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

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.ops import ssim as t_ssim
from ai_based_frame_interpolation_torch.ops.psnr import psnr as t_psnr
from ai_based_frame_interpolation_torch.ops import ssim_fused as t_fused
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


def _ssim_of(sx, sy, sxx, syy, sxy, c1, c2):
    """The kernel's algebra on f32 window sums, each step rounded."""
    f = np.float32
    n, cov = f(49.0), f(1.0 / 48.0)
    ux, uy = sx / n, sy / n
    vx, vy = (sxx - sx * ux) * cov, (syy - sy * uy) * cov
    vxy = (sxy - sx * uy) * cov
    num = (f(2.0) * ux * uy + f(c1)) * (f(2.0) * vxy + f(c2))
    den = (ux * ux + uy * uy + f(c1)) * (vx + vy + f(c2))
    return num / den


def _window_sums(x, y, dtype):
    """The five 7x7 window sums of a plane at every valid position: exact
    (int64) for uint8; in the Pallas order for f32 (7 columns left to
    right, then the 7 row sums top to bottom)."""
    if dtype == torch.uint8:
        q = [v.astype(np.int64) for v in (x, y)]
        q += [q[0] * q[0], q[1] * q[1], q[0] * q[1]]
        return [sum(v[dy:dy + v.shape[0] - 6, dx:dx + v.shape[1] - 6]
                    for dy in range(7) for dx in range(7)) for v in q]
    q = [x, y, x * x, y * y, x * y]
    out = []
    for v in q:
        h = v[:, 0:v.shape[1] - 6]
        for d in range(1, 7):
            h = h + v[:, d:d + v.shape[1] - 6]
        s = h[0:h.shape[0] - 6]
        for d in range(1, 7):
            s = s + h[d:d + h.shape[0] - 6]
        out.append(s)
    return out


def _shuffle_tree(acc):
    """__shfl_down_sync's sum over 32 lanes, as the kernel adds."""
    acc = acc.copy()
    for off in (16, 8, 4, 2, 1):
        acc[:32 - off] = acc[:32 - off] + acc[off:]
    return acc[0]


def _mean_kernel(parts, count):
    """ssim_mean_kernel: 256 threads sum a strided share of the partials
    in f64, then halve in a tree; the sum over the count, as f32."""
    sums = np.zeros(256, np.float64)
    for t in range(256):
        for v in parts[t::256]:
            sums[t] += np.float64(v)
    half = 128
    while half:
        sums[:half] = sums[:half] + sums[half:2 * half]
        half //= 2
    return np.float32(sums[0] / count)


def _kernel_decomposition(x, y, dtype, data_range, sms):
    """csrc/ssim_eval.cu's arithmetic, emulated on a card of ``sms`` SMs:
    each (plane, strip, band) warp streams its input rows, each lane keeps
    int32 column sums over the last 7 rows (uint8: add the row entering,
    subtract the one leaving; then slide the horizontal sums along its
    columns) or a ring of the last 7 rows' horizontal sums (f32: summed
    top to bottom), sums its values in order, and every 2 output rows
    the warp adds them by a shuffle tree into that strip's partial; the
    partials in f64. Returns ([B] SSIM, [B] partials, every window's five
    sums [B,C][5][VH,VW])."""
    b_, h, w, c_ = x.shape
    vh, vw = h - 6, w - 6
    strips, bands, band_h = t_fused.band_geometry(b_, c_, h, w, dtype, sms)
    groups = -(-vh // t_fused.GROUP)
    assert strips * groups <= t_fused.partials_per_plane(h, w)
    cpt, sc = t_fused.LANE_COLS[dtype], t_fused.strip_cols(dtype)
    c1, c2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    res, partials, sums = [], [], {}
    for b in range(b_):
        parts = np.full((c_, strips, groups), np.nan, np.float32)
        for c in range(c_):
            xp, yp = x[b, :, :, c], y[b, :, :, c]
            got = np.zeros((5, vh, vw), np.int64 if dtype == torch.uint8
                           else np.float32)
            for strip in range(strips):
                x0 = strip * sc
                for band in range(bands):
                    oy0 = band * band_h
                    rows_out = min(band_h, vh - oy0)
                    acc = np.zeros(32, np.float32)

                    def flush(row, acc):
                        if (row + 1) % t_fused.GROUP and row != oy0 + rows_out - 1:
                            return acc
                        assert np.isnan(parts[c, strip, row // t_fused.GROUP])
                        parts[c, strip, row // t_fused.GROUP] = _shuffle_tree(acc)
                        return np.zeros(32, np.float32)
                    # each lane's columns: CPT outputs and 6 more (clipped
                    # reads past the image only feed outputs not kept)
                    cols = x0 + np.arange(32)[:, None] * cpt + np.arange(
                        cpt + 6)[None, :]
                    cols = np.minimum(cols, w - 1)
                    if dtype == torch.uint8:
                        col = np.zeros((5, 32, cpt + 6), np.int64)
                        for i in range(rows_out + 6):
                            for k, sign in ((i, 1), (i - 7, -1)):
                                if k < 0:
                                    continue
                                a = xp[oy0 + k, cols].astype(np.int64)
                                bb = yp[oy0 + k, cols].astype(np.int64)
                                col += sign * np.stack([a, bb, a * a, bb * bb,
                                                        a * bb])
                            if i < 6:
                                continue
                            s = col[:, :, 0:7].sum(-1)
                            for j in range(cpt):
                                if j:
                                    s = s + col[:, :, j + 6] - col[:, :, j - 1]
                                ox = x0 + np.arange(32) * cpt + j
                                ok = ox < vw
                                got[:, oy0 + i - 6, ox[ok]] = s[:, ok]
                                v = _ssim_of(*s.astype(np.float32), c1, c2)
                                acc[ok] = acc[ok] + v[ok]
                            acc = flush(oy0 + i - 6, acc)
                    else:
                        ring = [None] * 7
                        for i in range(rows_out + 6):
                            a, bb = xp[oy0 + i, cols], yp[oy0 + i, cols]
                            qs = [a, bb, a * a, bb * bb, a * bb]
                            hs = []
                            for q in qs:
                                hq = q[:, 0:cpt]
                                for d in range(1, 7):
                                    hq = hq + q[:, d:d + cpt]
                                hs.append(hq)
                            ring[i % 7] = np.stack(hs)
                            if i < 6:
                                continue
                            s = ring[(i + 1) % 7]
                            for d in range(2, 8):
                                s = s + ring[(i + d) % 7]
                            for j in range(cpt):
                                ox = x0 + np.arange(32) * cpt + j
                                ok = ox < vw
                                got[:, oy0 + i - 6, ox[ok]] = s[:, ok, j]
                                v = _ssim_of(*s[:, :, j], c1, c2)
                                acc[ok] = acc[ok] + v[ok]
                            acc = flush(oy0 + i - 6, acc)
            sums[b, c] = got
        assert not np.isnan(parts).any()           # every partial written once
        partials.append(parts.ravel())
        res.append(_mean_kernel(parts.ravel(), c_ * vh * vw))
    return np.asarray(res, np.float32), partials, sums


@pytest.mark.parametrize("shape,dtype", [
    ((1, 7, 7, 1), torch.uint8),        # one window
    ((2, 70, 16, 1), torch.uint8),
    ((1, 129, 257, 3), torch.uint8),    # RGB, two strips, the second 1 wide
    ((2, 71, 263, 1), torch.uint8),     # 65 rows: bands of 2, the last 1
    ((1, 263, 20, 1), torch.uint8),     # 257 rows: bands of 3, the last 2
    ((1, 70, 16, 1), torch.float32),
    ((1, 71, 71, 1), torch.float32),    # f32 strip edge: 65 columns
])
def test_kernel_decomposition_matches_plain_ssim_eval(shape, dtype):
    """The kernel's strips, bands and running sums (emulated): every window
    sum exact for uint8 and the Pallas order's for f32 (within 1e-6 of
    the exact sum, relative), and the SSIM within SSIM_BOUND of the plain
    ``ssim_eval``. The partials, and so the result's bits, are the same
    on a card of 132 SMs, of 114, and of 1 (other bands), and for the
    first image alone as in its batch."""
    npd = np.uint8 if dtype == torch.uint8 else np.float32
    a, b = _pair(shape, npd, seed=sum(shape))
    dr = 255.0 if dtype == torch.uint8 else 1.0
    got, parts, sums = _kernel_decomposition(a, b, dtype, dr, 132)
    for sms, n in ((114, shape[0]), (1, shape[0]), (132, 1)):
        other, other_parts, _ = _kernel_decomposition(a[:n], b[:n], dtype, dr,
                                                      sms)
        np.testing.assert_array_equal(other, got[:n])
        for p, q in zip(other_parts, parts):
            np.testing.assert_array_equal(p, q)
    for (i, c), s in sums.items():
        want = _window_sums(a[i, :, :, c], b[i, :, :, c], dtype)
        exact = _window_sums(a[i, :, :, c].astype(np.float64),
                             b[i, :, :, c].astype(np.float64), torch.float32)
        for q in range(5):
            np.testing.assert_array_equal(s[q], want[q])
            if dtype == torch.float32:
                np.testing.assert_allclose(s[q], exact[q], rtol=1e-6, atol=0)
    plain = t_ssim.ssim_eval(torch.from_numpy(a), torch.from_numpy(b),
                             data_range=dr).numpy()
    np.testing.assert_allclose(got, plain, rtol=0, atol=SSIM_BOUND)


def _rn32(x):
    """An exact rational rounded to the nearest f32 (ties to even)."""
    if x == 0:
        return Fraction(0)
    e = x.numerator.bit_length() - x.denominator.bit_length()
    if Fraction(2) ** e > x:
        e -= 1
    ulp = Fraction(2) ** (e - 23)
    q, rem = divmod(x, ulp)
    if rem * 2 > ulp or (rem * 2 == ulp and q % 2):
        q += 1
    return q * ulp


@pytest.mark.parametrize("lo,hi", [(0, 6248), (6248, 49 * 255 + 1)])
def test_kernel_division_by_49_is_ieee_for_every_uint8_window_sum(lo, hi):
    """csrc/ssim_eval.cu's div49 (q = RN(v * RN(1/49)), then
    RN(q + RN(v - 49 q) * RN(1/49)) by two FMAs) equals the IEEE quotient
    RN(v / 49) for every integer window sum v of uint8 images."""
    r = _rn32(Fraction(1, 49))
    assert float(r).hex() == "0x1.4e5e0a0000000p-6"       # the kernel's literal
    for v in range(lo, hi):
        q = _rn32(v * r)
        q1 = _rn32(_rn32(v - 49 * q) * r + q)
        assert q1 == _rn32(Fraction(v, 49)), v


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
