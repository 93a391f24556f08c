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
from ai_based_frame_interpolation_torch.ops.refine import (
    pack_head_weights, refine_head, refine_head_reference)
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
    before = refine_head.launches
    args = (torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
            _torch_params(fp), torch.bfloat16)
    assert torch.equal(refine_head(*args), refine_head_reference(*args))
    assert refine_head.launches == before


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
    before = refine_head.launches
    args = (torch.from_numpy(y), [torch.from_numpy(p) for p in planes],
            _torch_params(fp), torch.bfloat16)
    assert torch.equal(refine_head(*args, packed=pack_head_weights(args[2])),
                       refine_head_reference(*args))
    assert refine_head.launches == before


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
