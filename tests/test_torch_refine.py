"""The port's plain refinement head vs the JAX package's.

``refine_head_reference`` is held against the Pallas kernel
``refine_head_fused`` in interpret mode (as ``tests/test_refine_fused.py``
runs it on the CPU) and against the Flax head inside the model. Weights and
inputs come from numpy. Tolerances:

- f32: 1e-4, the same f32 sums in another order;
- bf16: both sides round each conv to bf16 before and after its bias, but
  the f32 sums run in another order, so a sum near a rounding boundary can
  land one bf16 ulp apart (0.0078 near 1) and carry into the next conv.
  Outputs agree within 2 ulp at |x| < 4 (atol 0.032) and bit for bit on
  at least 98% of the values.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.ops.dconv_fused import (
    double_conv_fused)
from ai_based_frame_interpolation_torch.ops.refine import (
    dconv_pair, head_route, pack_direct_head, pack_head_weights, refine_head,
    refine_head_dconv, refine_head_direct, refine_head_reference)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.ops.pallas.refine_fused import (
    refine_head_fused)

CPU = jax.devices("cpu")[0]


def _head_params(nplanes, c, width, seed=0):
    """Flax-layout head params (HWIO kernels) drawn from numpy."""
    gen = np.random.default_rng(seed)

    def conv(k, cin, cout):
        return {"kernel": (gen.standard_normal((k, k, cin, cout))
                           / np.sqrt(k * k * cin)).astype(np.float32),
                "bias": (0.1 * gen.standard_normal(cout)).astype(np.float32)}

    return {"refine1": conv(3, nplanes, width),
            "refine2": conv(3, width, width),
            "refine_out": conv(1, width, c)}


def _torch_params(flax_params):
    state = flax_to_state_dict({"params": flax_params})
    return {n: {"weight": state[f"{n}.weight"], "bias": state[f"{n}.bias"]}
            for n in flax_params}


def _inputs(b, h, w, c, nextra, seed=1):
    gen = np.random.default_rng(seed)
    y = gen.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
    planes = [gen.uniform(-1, 1, (b, h, w, c)).astype(np.float32)
              for _ in range(nextra)]
    return y, planes


def _bf16_close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=0.032)
    assert float((got == want).mean()) >= 0.98


# (batch, height, width, channels, planes besides the prediction): heights
# 32 (a multiple of 16) and 24 (not); 3, 5 and 9 input planes
SHAPES = [(2, 24, 32, 1, 2), (1, 32, 32, 1, 4), (1, 24, 32, 3, 2)]


@pytest.mark.parametrize("b,h,w,c,nextra", SHAPES)
def test_reference_matches_pallas_interpret(b, h, w, c, nextra):
    nplanes = (1 + nextra) * c
    fp = _head_params(nplanes, c, width=16)
    y, planes = _inputs(b, h, w, c, nextra)
    with jax.default_device(CPU):
        want = np.asarray(refine_head_fused(
            jnp.asarray(y), tuple(jnp.asarray(p, jnp.bfloat16) for p in planes),
            fp["refine1"], fp["refine2"], fp["refine_out"],
            interpret=True), np.float32)
    got = refine_head_reference(
        torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
        _torch_params(fp), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    _bf16_close(got.float().numpy(), want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reference_matches_flax_head(dtype):
    cfg = JConfig(base_width=4, depth=2, space_to_depth=2, residual=True,
                  refine_width=8)
    jdt = getattr(jnp, dtype)
    model = j_build(cfg, jdt)
    b, h, w = 2, 24, 32
    _, (f1, f2) = _inputs(b, h, w, 1, 2, seed=3)
    shapes = jax.eval_shape(lambda a: model.init(jax.random.key(0), a, a,
                                                 train=False),
                            jax.ShapeDtypeStruct(f1.shape, jnp.float32))
    gen = np.random.default_rng(4)
    variables = jax.tree.map(
        lambda a: (0.3 * gen.standard_normal(a.shape) + (
            1.0 if len(a.shape) == 1 else 0.0)).astype(np.float32), shapes)
    params = variables["params"]
    full, pre = jax.jit(lambda v, a, c: (
        model.apply(v, a, c, train=False).astype(jnp.float32),
        model.apply(v, a, c, train=False, skip_refine=True)))(
        variables, f1, f2)
    full, pre = np.asarray(full), np.array(pre, np.float32)
    head = {n: params[n] for n in ("refine1", "refine2", "refine_out")}
    got = refine_head_reference(
        torch.from_numpy(pre), [torch.from_numpy(f1), torch.from_numpy(f2)],
        _torch_params(jax.tree.map(np.asarray, head)),
        getattr(torch, dtype)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, full, rtol=0, atol=1e-4)
    else:
        _bf16_close(got, full)


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    fp = _head_params(3, 1, width=64)
    y, planes = _inputs(1, 16, 16, 1, 2)
    before = (refine_head.launches, dict(refine_head.routes))
    args = (torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
            _torch_params(fp), torch.bfloat16)
    assert torch.equal(refine_head(*args), refine_head_reference(*args))
    assert (refine_head.launches, dict(refine_head.routes)) == before


@pytest.mark.parametrize("c,nextra,width", [(1, 2, 64), (1, 4, 16),
                                            (3, 4, 16)])
def test_packed_weights_are_the_kernel_layout(c, nextra, width):
    """The weights a model packs once (``pack_head_weights``) are the
    layouts the kernel reads: computing the head from them as the kernel
    indexes them (conv1 over (tap, plane) columns, conv2 as (tap, out, in),
    the out conv as (in, C)) gives the plain head, in f32."""
    nplanes = (1 + nextra) * c
    # conv weights that bf16 holds exactly, so the f32 check is exact too
    params = {n: {k: v.bfloat16().float() for k, v in p.items()}
              for n, p in _torch_params(_head_params(nplanes, c, width)).items()}
    y, planes = _inputs(1, 12, 20, c, nextra)
    y, planes = torch.from_numpy(y), [torch.from_numpy(p) for p in planes]
    kw = {k: v.float() for k, v in pack_head_weights(params).items()}
    assert tuple(kw["w1"].shape) == (width, 9 * nplanes)
    assert tuple(kw["w2"].shape) == (9, width, width)
    assert tuple(kw["w3"].shape) == (width, c)

    def taps(z):                      # [B,H,W,K] -> [B,H,W,9,K], SAME pad
        zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
        h, w = z.shape[1:3]
        return torch.stack([zp[:, dy:dy + h, dx:dx + w]
                            for dy in range(3) for dx in range(3)], 3)

    z = torch.cat([y] + planes, -1)
    z1 = torch.relu(taps(z).flatten(3) @ kw["w1"].t() + kw["b1"])
    z2 = torch.relu(torch.einsum("bhwtk,tok->bhwo", taps(z1), kw["w2"])
                    + kw["b2"])
    got = y + z2 @ kw["w3"] + kw["b3"]
    want = refine_head_reference(y, planes, params, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)
    # the CPU wrapper's result does not depend on the packed weights
    args = (y, planes, params, torch.bfloat16)
    assert torch.equal(refine_head(*args, packed=pack_head_weights(params)),
                       refine_head(*args))


def _dw_head_params(nplanes, c, width, seed=0):
    """Flax-layout depthwise head params: refine2 split into a depthwise
    3x3 (kernel (3, 3, 1, w)) and a pointwise 1x1."""
    params = _head_params(nplanes, c, width, seed)
    gen = np.random.default_rng(seed + 100)
    del params["refine2"]
    params["refine2_dw"] = {
        "kernel": (gen.standard_normal((3, 3, 1, width)) / 3.0)
        .astype(np.float32),
        "bias": (0.1 * gen.standard_normal(width)).astype(np.float32)}
    params["refine2_pw"] = {
        "kernel": (gen.standard_normal((1, 1, width, width))
                   / np.sqrt(width)).astype(np.float32),
        "bias": (0.1 * gen.standard_normal(width)).astype(np.float32)}
    return params


def test_depthwise_reference_matches_pallas_interpret():
    """The plain depthwise head vs the Pallas head's depthwise branch, at
    head width 8 and 1x24x16 gray: three 8-row tiles (with one tile, the
    CPU backend has no bf16 dot for the pointwise conv)."""
    b, h, w, c, nextra = 1, 24, 16, 1, 2
    fp = _dw_head_params((1 + nextra) * c, c, width=8)
    y, planes = _inputs(b, h, w, c, nextra, seed=5)
    with jax.default_device(CPU):
        want = np.asarray(refine_head_fused(
            jnp.asarray(y), tuple(jnp.asarray(p, jnp.bfloat16) for p in planes),
            fp["refine1"], None, fp["refine_out"],
            refine2_dw=fp["refine2_dw"], refine2_pw=fp["refine2_pw"],
            interpret=True), np.float32)
    got = refine_head_reference(
        torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
        _torch_params(fp), torch.bfloat16)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (b, h, w, c)
    _bf16_close(got.float().numpy(), want)


def test_packed_depthwise_weights_are_the_kernel_layout():
    """The depthwise head's packed layouts (wdw (tap, channel) in f32 from
    bf16, wpw (out, in)) give the plain depthwise head, in f32, when the
    head is computed from them as the kernel indexes them."""
    c, nextra, width = 1, 2, 64
    nplanes = (1 + nextra) * c
    params = {n: {k: v.bfloat16().float() for k, v in p.items()}
              for n, p in _torch_params(
                  _dw_head_params(nplanes, c, width)).items()}
    y, planes = _inputs(1, 12, 20, c, nextra)
    y, planes = torch.from_numpy(y), [torch.from_numpy(p) for p in planes]
    packed = pack_head_weights(params)
    assert "w2" not in packed and packed["wdw"].dtype == torch.float32
    assert torch.equal(packed["wdw"], packed["wdw"].bfloat16().float())
    kw = {k: v.float() for k, v in packed.items()}
    assert tuple(kw["wdw"].shape) == (9, width)
    assert tuple(kw["wpw"].shape) == (width, width)

    def taps(z):                      # [B,H,W,K] -> [B,H,W,9,K], SAME pad
        zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
        h, w = z.shape[1:3]
        return torch.stack([zp[:, dy:dy + h, dx:dx + w]
                            for dy in range(3) for dx in range(3)], 3)

    z = torch.cat([y] + planes, -1)
    z1 = torch.relu(taps(z).flatten(3) @ kw["w1"].t() + kw["b1"])
    zdw = (taps(z1) * kw["wdw"]).sum(3) + kw["bdw"]
    z2 = torch.relu(zdw @ kw["wpw"].t() + kw["bpw"])
    got = y + z2 @ kw["w3"] + kw["b3"]
    want = refine_head_reference(y, planes, params, torch.float32)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_cpu_wrapper_runs_the_plain_depthwise_head_without_launching():
    fp = _dw_head_params(3, 1, width=64)
    y, planes = _inputs(1, 16, 16, 1, 2)
    before = (refine_head.launches, dict(refine_head.routes))
    args = (torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
            _torch_params(fp), torch.bfloat16)
    assert torch.equal(refine_head(*args, packed=pack_head_weights(args[2])),
                       refine_head_reference(*args))
    assert (refine_head.launches, dict(refine_head.routes)) == before


def test_depthwise_engine_matches_jax():
    """The port engine with the depthwise head (``refine_depthwise=True``)
    within 1 uint8 LSB of the JAX engine, f32, on bridged weights."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_tpu.infer.engine import (
        InterpolationEngine as JEngine)
    from test_torch_unet import random_variables

    kw = dict(base_width=8, depth=2, space_to_depth=4, residual=True,
              refine_width=8, refine_depthwise=True, upsample="half_pixel")
    variables = random_variables(kw, (32, 48), seed=2)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = InterpolationEngine.from_flax_variables(
        variables, ModelConfig(**kw), compute_dtype=torch.float32,
        device="cpu")
    assert "wdw" in teng.model.packed_head
    gen = np.random.default_rng(6)
    f1 = gen.integers(0, 256, (2, 40, 56, 1), dtype=np.uint8)
    f2 = np.roll(f1, 2, axis=2)
    got, want = teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max()) <= 1


def _ordered_head(y, planes, params, cdt):
    """The plain head with every sum taken in one fixed order (tap, then
    input channel, one f32 multiply-add after another), the dtype's
    rounding points as ``refine_head_reference``'s: appending zero
    channels to a conv's input or output cannot change a bit of it, where
    a library conv may block the channels differently at another width."""
    def conv(z, p, groups=1):
        w = p["weight"].to(cdt).float()
        k = w.shape[-1]
        zp = torch.nn.functional.pad(z.float(), (0, 0, k // 2, k // 2,
                                                 k // 2, k // 2))
        h, wd = z.shape[1:3]
        acc = torch.zeros(*z.shape[:3], w.shape[0])
        for dy in range(k):
            for dx in range(k):
                win = zp[:, dy:dy + h, dx:dx + wd]
                if groups > 1:
                    acc = acc + win * w[:, 0, dy, dx]
                    continue
                for i in range(z.shape[-1]):
                    acc = acc + win[..., i:i + 1] * w[:, i, dy, dx]
        return acc.to(cdt) + p["bias"].to(cdt)

    z = torch.cat([y.to(cdt)] + [p.to(cdt) for p in planes], -1)
    z = torch.relu(conv(z, params["refine1"]))
    if "refine2" in params:
        z = torch.relu(conv(z, params["refine2"]))
    else:
        z = conv(z, params["refine2_dw"], groups=z.shape[-1])
        z = torch.relu(conv(z, params["refine2_pw"]))
    delta = conv(z.float(), {k: v.float() for k, v in
                             params["refine_out"].items()})
    return (y.float() + delta).to(cdt)


@pytest.mark.parametrize("width,depthwise,dtype", [
    (w, dw, dt) for w, dw in ((4, False), (8, False), (32, False),
                              (16, True))
    for dt in ("float32", "bfloat16")])
def test_padded_packing_is_exact(width, depthwise, dtype):
    """A bf16 head narrower than its kernel instance is packed with zeros
    up to the instance's width (16 or 64): the head rebuilt from the padded
    packed weights equals the unpadded head bit for bit, in f32 and bf16
    (a padded channel carries relu(0) = 0 and adds exact zeros), with the
    sums in one fixed order; the plain head (a library conv) agrees bit
    for bit in bf16 and within 1e-6 in f32."""
    c, nextra = 1, 2
    nplanes = (1 + nextra) * c
    fp = _dw_head_params(nplanes, c, width) if depthwise else \
        _head_params(nplanes, c, width)
    params = {n: {k: v.bfloat16().float() for k, v in p.items()}
              for n, p in _torch_params(fp).items()}
    kw = {k: v.float() for k, v in pack_head_weights(params).items()}
    wd = 64 if depthwise or width > 16 else 16
    assert tuple(kw["w1"].shape) == (wd, 9 * nplanes)
    padded = {
        "refine1": {"weight": kw["w1"].reshape(wd, 3, 3, nplanes)
                    .permute(0, 3, 1, 2), "bias": kw["b1"]},
        "refine_out": {"weight": kw["w3"].t().reshape(c, wd, 1, 1),
                       "bias": kw["b3"]}}
    if depthwise:
        padded["refine2_dw"] = {"weight": kw["wdw"].t().reshape(wd, 1, 3, 3),
                                "bias": kw["bdw"]}
        padded["refine2_pw"] = {"weight": kw["wpw"].reshape(wd, wd, 1, 1),
                                "bias": kw["bpw"]}
    else:
        padded["refine2"] = {"weight": kw["w2"].reshape(3, 3, wd, wd)
                             .permute(2, 3, 0, 1), "bias": kw["b2"]}
    y, planes = _inputs(1, 12, 20, c, nextra, seed=7)
    y, planes = torch.from_numpy(y), [torch.from_numpy(p) for p in planes]
    cdt = getattr(torch, dtype)
    assert torch.equal(_ordered_head(y, planes, padded, cdt),
                       _ordered_head(y, planes, params, cdt))
    got = refine_head_reference(y, planes, padded, cdt)
    want = refine_head_reference(y, planes, params, cdt)
    if dtype == "bfloat16":
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6)


def _fused_conv1(z, w1, b1):
    """conv1 of the fused kernel (``csrc/refine_head.cu``) emulated tile by
    tile with its operand indexing: the 20x20 pixel-major bf16 halo with
    the planes zero-padded to P (a multiple of 4), the per-block quad
    offset table, the conv1 weights reordered into the m16n8k16 column
    order (lane t's quad: columns 2t, 2t+1, 2t+8, 2t+9), pad quads zero.
    Each window row's products are summed in one fixed order (K index,
    i.e. tap then plane, one f32 multiply-add after another). z: [B,H,W,n]
    float (bf16 values); w1: the packed [WD, 9n]; b1: [WD]. Returns the
    bf16 z1 of every tile window, [tiles, 324, WD], zero outside the
    image, and each window pixel's image coordinates."""
    b, h, w, n = z.shape
    wd = w1.shape[0]
    p = (n + 3) // 4 * 4
    kp = (9 * p + 15) // 16 * 16
    nq = 9 * p // 4
    qoff = []                             # the kernel's qoff table
    for q in range(kp // 4):
        tap = 4 * q // p
        qoff.append(((tap // 3) * 20 + tap % 3) * p + 4 * q - tap * p
                    if q < nq else -1)
    w1s = torch.zeros(wd, kp)             # the kernel's w1s, MMA column order
    kk_of = []                            # K index of each MMA column
    for c in range(kp):
        cc = c % 16
        kk = c - cc + 4 * ((cc % 8) // 2) + 2 * (cc // 8) + cc % 2
        kk_of.append(kk)
        tap, pl = divmod(kk, p)
        if tap < 9 and pl < n:
            w1s[:, c] = w1[:, tap * n + pl]
    # the halo element each MMA column of each window row reads (-1: zero)
    m = torch.arange(324)
    hb = ((m // 18) * 20 + m % 18) * p
    cols = []
    for c in range(kp):
        ks, cc = divmod(c, 16)
        q = ks * 4 + (cc % 8) // 2
        cols.append(hb + qoff[q] + 2 * (cc // 8) + cc % 2 if qoff[q] >= 0
                    else torch.full((324,), -1))
    idx = torch.stack(cols, 1)            # [324, kp]
    order = sorted(range(kp), key=lambda c: kk_of[c])
    zp = torch.nn.functional.pad(z, (0, p - n, 2, 2, 2, 2))   # zero halo
    bf16 = torch.bfloat16
    out, coords = [], []
    for bi in range(b):
        for y0 in range(0, h, 16):
            for x0 in range(0, w, 16):
                halo = torch.zeros(20, 20, p)
                win = zp[bi, y0:y0 + 20, x0:x0 + 20]
                halo[:win.shape[0], :win.shape[1]] = win
                flat = torch.cat([halo.reshape(-1), torch.zeros(1)])
                a = flat[idx]             # idx -1 reads the appended zero
                acc = torch.zeros(324, wd)
                for c in order:
                    acc = acc + a[:, c:c + 1] * w1s[:, c]
                z1 = torch.relu(acc.to(bf16) + b1.to(bf16))
                gy = y0 - 1 + m // 18
                gx = x0 - 1 + m % 18
                inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
                out.append(torch.where(inside[:, None], z1,
                                       torch.zeros((), dtype=bf16)))
                coords.append((bi, gy, gx, inside))
    return torch.stack(out), coords


@pytest.mark.parametrize("b,h,w,c,nextra", [
    (2, 19, 21, 1, 2), (1, 13, 17, 3, 2), (2, 19, 21, 1, 4),
    (1, 13, 17, 3, 4)])
def test_fused_conv1_operands_are_exact(b, h, w, c, nextra):
    """The fused kernel's conv1 operand indexing (halo layout, zero pads,
    the K order of its conv1 weights in shared memory, read from the packed
    w1) is conv1: emulated on odd-sized gray and RGB inputs with 3, 5, 9
    and 15 planes, every tile window equals the plain conv1 (SAME padding,
    zero outside the image) bit for bit with fixed-order sums."""
    nplanes = (1 + nextra) * c
    width = 64 if nextra == 2 else 16
    params = {k: {n: v.bfloat16().float() for n, v in q.items()}
              for k, q in _torch_params(_head_params(nplanes, c, width,
                                                     seed=3)).items()}
    kw = {k: v.float() for k, v in pack_head_weights(params).items()}
    y, planes = _inputs(b, h, w, c, nextra, seed=4)
    z = torch.cat([torch.from_numpy(t) for t in [y] + planes], -1) \
        .bfloat16().float()
    got, coords = _fused_conv1(z, kw["w1"], kw["b1"])
    w1 = params["refine1"]["weight"]          # plain: tap, then plane
    zp = torch.nn.functional.pad(z, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(b, h, w, width)
    for dy in range(3):
        for dx in range(3):
            for i in range(nplanes):
                acc = acc + zp[:, dy:dy + h, dx:dx + w, i:i + 1] \
                    * w1[:, i, dy, dx]
    want = torch.relu(acc.bfloat16() + params["refine1"]["bias"].bfloat16())
    for t, (bi, gy, gx, inside) in enumerate(coords):
        assert not got[t][~inside].float().any()
        assert torch.equal(got[t][inside], want[bi, gy[inside], gx[inside]])


def test_head_route():
    """Each (width, compute dtype, depthwise) goes to its documented
    kernel: bf16 dense widths 1-16 to the w16 instance, 17-64 to w64,
    65-256 to the tensor-core double conv ("dconv"), depthwise 1-64 to the
    depthwise instance, wider bf16 heads (depthwise above 64, dense above
    256) and every f32 head to the direct convs; another dtype raises."""
    bf16, f32 = torch.bfloat16, torch.float32
    table = {(1, bf16, False): "w16", (4, bf16, False): "w16",
             (16, bf16, False): "w16", (17, bf16, False): "w64",
             (32, bf16, False): "w64", (64, bf16, False): "w64",
             (65, bf16, False): "dconv", (128, bf16, False): "dconv",
             (256, bf16, False): "dconv", (257, bf16, False): "direct",
             (320, bf16, False): "direct", (16, bf16, True): "dw64",
             (64, bf16, True): "dw64", (96, bf16, True): "direct",
             (128, bf16, True): "direct", (16, f32, False): "direct",
             (64, f32, False): "direct", (128, f32, False): "direct",
             (64, f32, True): "direct"}
    for (w, dt, dw), route in table.items():
        assert head_route(w, dt, dw) == route, (w, dt, dw)
    with pytest.raises(ValueError, match="bf16 or f32"):
        head_route(64, torch.float16, False)


@pytest.mark.parametrize("width,depthwise,dtype", [
    (64, False, "float32"), (16, True, "float32"), (96, False, "bfloat16")])
def test_direct_head_composition_matches_plain(width, depthwise, dtype):
    """The direct route's composition (conv, conv or depthwise+pointwise,
    then the f32 out conv; here on the kernels' plain versions) against
    the plain head: f32 within 1e-5; bf16 within one bf16 ulp at |x| < 2
    (the same rounding points, the residual summed in another order). The
    dense bf16 case is what heads wider than 256 take, here at width 96
    for size (``pack_direct_head``: ``head_route`` sends 96 to dconv)."""
    c, nextra = 1, 2
    nplanes = (1 + nextra) * c
    fp = _dw_head_params(nplanes, c, width) if depthwise else \
        _head_params(nplanes, c, width)
    params = _torch_params(fp)
    cdt = getattr(torch, dtype)
    packed = pack_direct_head(params, cdt)
    if head_route(width, cdt, depthwise) == "direct":
        assert all(torch.equal(packed[k], v) for k, v in
                   pack_head_weights(params, cdt).items())
    assert tuple(packed["w1"].shape) == (9, nplanes, width)
    y, planes = _inputs(1, 12, 20, c, nextra, seed=8)
    y, planes = torch.from_numpy(y), [torch.from_numpy(p) for p in planes]
    got = refine_head_direct(y, planes, packed, cdt)
    want = refine_head_reference(y, planes, params, cdt)
    assert got.dtype == cdt and got.shape == want.shape
    atol = 1e-5 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=0, atol=atol)


@pytest.mark.parametrize("width,nextra", [(72, 2), (72, 4), (100, 2),
                                          (128, 2), (128, 4)])
def test_dconv_head_packing_is_exact(width, nextra):
    """A dense bf16 head of width 65-256 (the ``"dconv"`` route) is packed
    as the double-conv kernel reads it: planes and width zero-padded to
    multiples of 8 (``dconv_pair``; to 16 inside the chunk stream), w3
    with zero rows. The head rebuilt from the chunk stream (read back as
    the kernel locates each chunk) over the input with zero planes
    appended, conv2 cut to the channels the kernel stores, equals the
    unpadded head bit for bit with the sums in one fixed order; the
    route's plain composition (``refine_head_dconv``) equals the plain
    head bit for bit."""
    from test_torch_dconv import _unchunk

    c, bf16 = 1, torch.bfloat16
    nplanes = (1 + nextra) * c
    params = {n: {k: v.bfloat16().float() for k, v in p.items()}
              for n, p in _torch_params(_head_params(nplanes, c, width))
              .items()}
    packed = pack_head_weights(params)
    wd = (width + 7) // 8 * 8
    kin, midp = (nplanes + 15) // 16 * 16, (wd + 15) // 16 * 16
    assert [tuple(t.shape) for t in dconv_pair(params)] == [
        (wd, (nplanes + 7) // 8 * 8, 3, 3), (wd,), (wd, wd, 3, 3), (wd,)]
    assert tuple(packed["w3"].shape) == (wd, c)
    assert not packed["w3"][width:].any()

    def oihw(flat, n, k):          # the chunk stream as [n][k][3][3]
        return _unchunk(flat.float(), n, k).reshape(3, 3, n, k) \
            .permute(2, 3, 0, 1)

    padded = {"refine1": {"weight": oihw(packed["w1"], midp, kin),
                          "bias": packed["b1"].float()},
              "refine2": {"weight": oihw(packed["w2"], midp, midp)[:wd],
                          "bias": packed["b2"].float()[:wd]},
              "refine_out": {"weight": packed["w3"].t().reshape(c, wd, 1, 1),
                             "bias": packed["b3"]}}
    y, planes = _inputs(1, 12, 20, c, nextra, seed=11)
    y, planes = torch.from_numpy(y), [torch.from_numpy(p) for p in planes]
    zeros = torch.zeros(*y.shape[:3], kin - nplanes)
    assert torch.equal(_ordered_head(y, planes + [zeros], padded, bf16),
                       _ordered_head(y, planes, params, bf16))
    assert torch.equal(refine_head_dconv(y, planes, params, packed),
                       refine_head_reference(y, planes, params, bf16))


def test_cpu_wrapper_runs_the_dconv_head_without_launching():
    """A bf16 head of width 128 (the ``"dconv"`` route on the card) on CPU
    tensors runs the plain head: no launch of refine_head, double_conv_fused
    or head_out_direct, and no route counted."""
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        head_out_direct)

    params = _torch_params(_head_params(3, 1, width=128))
    y, planes = _inputs(1, 16, 16, 1, 2)

    def counters():
        return (refine_head.launches, dict(refine_head.routes),
                double_conv_fused.launches, dict(double_conv_fused.routes),
                head_out_direct.launches)

    before = counters()
    args = (torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
            params, torch.bfloat16)
    assert torch.equal(refine_head(*args, packed=pack_head_weights(params)),
                       refine_head_reference(*args))
    assert counters() == before


@pytest.mark.cuda
def test_every_head_route_matches_plain_on_the_card():
    """On the card (skips here): padded heads (w8, w32, depthwise w16) on
    the fused instances, the bf16 w128 and w256 heads on the double conv
    ("dconv"), the bf16 depthwise w128 head and the f32 heads on the direct
    convs, each within one bf16 ulp at the output's magnitude (f32: 1e-4,
    TF32 off) of the plain head, with its launches counted."""
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        conv_direct, head_out_direct)

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc")
    c, nextra = 1, 2
    nplanes = (1 + nextra) * c
    y, planes = _inputs(2, 40, 72, c, nextra, seed=9)
    y = torch.from_numpy(y).cuda()
    planes = [torch.from_numpy(p).cuda().bfloat16() for p in planes]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for width, dw, dt in ((8, False, torch.bfloat16),
                              (32, False, torch.bfloat16),
                              (16, True, torch.bfloat16),
                              (128, False, torch.bfloat16),
                              (256, False, torch.bfloat16),
                              (128, True, torch.bfloat16),
                              (64, False, torch.float32),
                              (64, True, torch.float32)):
            fp = _dw_head_params(nplanes, c, width) if dw else \
                _head_params(nplanes, c, width)
            params = {n: {k: v.cuda() for k, v in p.items()}
                      for n, p in _torch_params(fp).items()}
            route = head_route(width, dt, dw)
            key = f"{route}/{'dw' if dw else 'w'}{width}/{str(dt)[6:]}"

            def counts():
                return (refine_head.launches, double_conv_fused.launches,
                        conv_direct.launches, head_out_direct.launches,
                        refine_head.routes[key])

            n = counts()
            got = refine_head(y, planes, params, dt,
                              pack_head_weights(params, dt))
            want = refine_head_reference(y, planes, params, dt)
            step = {"direct": (0, 0, 2 + dw, 1, 3 + dw),
                    "dconv": (0, 1, 0, 1, 2)}.get(route, (1, 0, 0, 0, 1))
            assert counts() == tuple(a + d for a, d in zip(n, step)), route
            err = float((got.float() - want.float()).abs().max())
            # bf16: one ulp at the output's magnitude
            mag = float(want.float().abs().max())
            tol = 1e-4 if dt == torch.float32 else 2.0 ** (
                np.floor(np.log2(mag)) - 7)
            assert err <= tol, (width, dw, dt, err)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
