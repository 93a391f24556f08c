"""Port flow family vs the JAX/Flax flow family on bridged weights.

Weights (BatchNorm statistics included) are drawn from numpy and carried
into the port through ``models/bridge.py``; frames come from numpy too.
Tolerances:

- model steps in f32: 1e-4, the same f32 convolutions summed in another
  order (as ``test_torch_unet.py``);
- the head at bf16: the tolerance of ``test_torch_refine.py`` (2 bf16 ulp
  at |x| < 4, and bit for bit on at least 98% of the values) against the
  JAX kernel route, which computes the warps in f32 as the port does; the
  Flax ``sample`` warps in bf16 instead, so against it only the atol holds;
- engines: uint8 within 1 LSB, the repo's cross-program tolerance. The JAX
  engine runs its production kernels (``sampler_impl`` and ``refine_impl``
  "pallas", interpret mode on the CPU).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.models.unet import (
    fold_batchnorm as t_fold)
from ai_based_frame_interpolation_torch.serve.batcher import DynamicBatcher
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models.unet import (
    fold_batchnorm as j_fold)
from ai_based_frame_interpolation_tpu.ops.pallas.refine_fused import (
    refine_head_fused)
from ai_based_frame_interpolation_tpu.ops.pallas.warp_fused import (
    sample_fused as j_sample_fused)
from test_torch_refine import _bf16_close
from test_torch_unet import random_variables

# fs2 + r8: the production shape (pooled backbone, head) at a tiny width;
# fs1 + r0: the full-resolution backbone and no head
FLOW = {
    "fs2_r8": dict(arch="flow", base_width=4, depth=2, flow_scale=2,
                   refine_width=8, max_flow=8),
    "fs1_r0": dict(arch="flow", base_width=4, depth=2, flow_scale=1,
                   refine_width=0, max_flow=8),
}
HW = (32, 48)


def _frames(n=2, hw=HW, seed=1):
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    base = 0.6 * np.sin(x / 5.0) * np.cos(y / 4.0)
    f1 = np.stack([base + 0.1 * gen.standard_normal(hw) for _ in range(n)])
    f2 = np.roll(f1, 3, axis=2)
    return [a[..., None].astype(np.float32) for a in (f1, f2)]


def _port(kw, variables, dtype=torch.float32):
    model = t_build(TConfig(**kw), dtype)
    model.load_state_dict(flax_to_state_dict(variables))
    model.eval()
    model.pack_head()
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("case", sorted(FLOW))
def test_motion_sample_parts_and_forward_match_flax(case):
    kw = FLOW[case]
    variables = random_variables(kw, HW)
    jmodel = j_build(JConfig(**kw), jnp.float32)
    f1, f2 = _frames()
    t = np.array([0.3, 0.8], np.float32)
    jflow, jmask = jax.jit(lambda v, a, b: jmodel.apply(
        v, a, b, method="motion"))(variables, f1, f2)
    jparts = jax.jit(lambda v, *a: jmodel.apply(
        v, *a, method="sample_parts"))(variables, f1, f2, jflow, jmask, t)
    jout = jax.jit(lambda v, a, b, tt: jmodel.apply(v, a, b, tt))(
        variables, f1, f2, t)

    model = _port(kw, variables)
    with torch.inference_mode():
        x1, x2, tt = _nchw(f1), _nchw(f2), torch.from_numpy(t)
        flow, mask = model.motion(x1, x2)
        parts = model.sample_parts(x1, x2, flow, mask, tt)
        out = model(x1, x2, tt)
    close = dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_nhwc(flow), np.asarray(jflow), **close)
    np.testing.assert_allclose(_nhwc(mask), np.asarray(jmask), **close)
    for got, want in zip(parts, jparts):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **close)
    assert tuple(out.shape) == (2, 1, *HW)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), **close)


def test_sample_at_bf16_matches_the_jax_kernel_route():
    kw = FLOW["fs2_r8"]
    variables = random_variables(kw, HW)
    f1, f2 = _frames()
    gen = np.random.default_rng(5)
    flow = gen.uniform(-12, 12, (2, *HW, 2)).astype(np.float32)
    mask = gen.uniform(0, 1, (2, *HW, 1)).astype(np.float32)
    t = np.array([0.5, 0.25], np.float32)
    bf = [jnp.asarray(a, jnp.bfloat16) for a in (f1, f2)]
    p = variables["params"]
    out, g0, g1 = j_sample_fused(*bf, flow, mask, t, max_flow=8,
                                 interpret=True)
    want = np.asarray(refine_head_fused(
        out, (g0, g1, *bf), p["refine1"], p["refine2"], p["refine_out"],
        interpret=True), np.float32)
    flax = np.asarray(jax.jit(lambda v, *a: j_build(
        JConfig(**kw), jnp.bfloat16).apply(v, *a, method="sample"))(
        variables, *bf, flow, mask, t), np.float32)

    model = _port(kw, variables, torch.bfloat16)
    with torch.inference_mode():
        got = model.sample(_nchw(f1).to(torch.bfloat16),
                           _nchw(f2).to(torch.bfloat16), _nchw(flow),
                           _nchw(mask), torch.from_numpy(t))
    assert got.dtype == torch.bfloat16
    _bf16_close(_nhwc(got), want)
    np.testing.assert_allclose(_nhwc(got), flax, rtol=0, atol=0.032)


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_maps_the_flow_family(folded):
    kw = FLOW["fs2_r8"]
    variables = random_variables(kw, HW)
    if folded:
        variables = jax.tree.map(np.asarray, j_fold(variables))
    state = flax_to_state_dict(variables)
    model = t_build(TConfig(**kw), torch.float32, folded=folded)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert any(k.startswith("motion_unet.down2.conv.") for k in state)
    # the cascade's keys map (HWIO -> OIHW); a key no module has raises
    kw = dict(kw, flow_bidir=True, flow_cascade=2)
    variables = option_variables(kw)
    if folded:
        variables = jax.tree.map(np.asarray, j_fold(variables))
    state = flax_to_state_dict(variables)
    model = t_build(TConfig(**kw), torch.float32, folded=folded)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(
        state["cascade1_out.weight"].numpy(),
        np.asarray(variables["params"]["cascade1_out"]["kernel"]).transpose(
            3, 2, 0, 1))
    assert tuple(state["cascade0_1.weight"].shape) == (32, 9, 3, 3)
    bad = dict(variables, params=dict(variables["params"], cascade0_9={
        "kernel": np.zeros((3, 3, 32, 32), np.float32),
        "bias": np.zeros(32, np.float32)}))
    with pytest.raises(KeyError, match="cascade0_9"):
        flax_to_state_dict(bad)


def test_fold_batchnorm_of_the_motion_backbone_matches_jax():
    variables = random_variables(FLOW["fs2_r8"], HW)
    want = flax_to_state_dict(jax.tree.map(np.asarray, j_fold(variables)))
    got = t_fold(flax_to_state_dict(variables))
    assert set(got) == set(want)
    assert any(k.startswith("motion_unet.inc.conv1.bias") for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def _engines():
    kw = FLOW["fs2_r8"]
    variables = random_variables(kw, HW)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32, refine_impl="pallas")
    jeng.sampler_impl = "pallas"
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    return jeng, teng


def _u8_pairs(n, h, w, seed=0):
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 80 * np.sin(x / 5.0) * np.cos(y / 4.0)
    f1 = np.stack([np.clip(base + gen.normal(0, 20, base.shape), 0, 255)
                   for _ in range(n)]).astype(np.uint8)[..., None]
    return f1, np.roll(f1, 3, axis=2)


def _within_1lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1


def test_flow_engine_matches_jax():
    # fs2 + r8 (the engine path of both kernels); fs1 + r0 is held to Flax
    # at the model level above
    jeng, teng = _engines()
    f1, f2 = _u8_pairs(2, 50, 60)    # not a multiple of the pad size
    _within_1lsb(teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2))
    got = teng.generate_intermediate_frames(f1[0], f2[0], num=3)
    want = jeng.generate_intermediate_frames(f1[0], f2[0], num=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _within_1lsb(g, w)
    assert teng.supports_exact_time
    got = teng.interpolate_at(f1[1], f2[1], [0.3, 0.7])
    want = jeng.interpolate_at(f1[1], f2[1], [0.3, 0.7])
    assert len(got) == 2
    for g, w in zip(got, want):
        _within_1lsb(g, w)


def test_time_conditioned_unet_serves_interpolate_at():
    kw = dict(base_width=4, depth=2, time_conditioned=True)
    variables = random_variables(kw, HW)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    f1, f2 = _u8_pairs(1, 40, 36, seed=3)
    for g, w in zip(teng.interpolate_at(f1[0], f2[0], [0.25, 0.6]),
                    jeng.interpolate_at(f1[0], f2[0], [0.25, 0.6])):
        _within_1lsb(g, w)
    plain = TEngine.random_init(TConfig(base_width=4, depth=2),
                                compute_dtype=torch.float32, device="cpu")
    assert not plain.supports_exact_time
    with pytest.raises(ValueError, match="time_conditioned"):
        plain.interpolate_at(f1[0], f2[0], [0.5])


def test_batcher_over_a_flow_engine():
    eng = TEngine.random_init(TConfig(**FLOW["fs2_r8"]), seed=0,
                              compute_dtype=torch.float32, device="cpu")
    batcher = DynamicBatcher(eng, max_batch=4)
    f1, f2 = _u8_pairs(6, 32, 40, seed=2)
    nums = [1 + 2 * (i % 2) for i in range(6)]
    results = [None] * 6
    gate = threading.Barrier(6)

    def request(i):
        gate.wait(timeout=30)
        results[i] = batcher.generate_intermediate_frames(f1[i], f2[i],
                                                          nums[i])

    threads = [threading.Thread(target=request, args=(i,)) for i in range(6)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    for i, frames in enumerate(results):
        want = eng.generate_intermediate_frames(f1[i], f2[i], nums[i])
        assert len(frames) == nums[i]
        for g, w in zip(frames, want):
            _within_1lsb(g, w)
    assert batcher.stats["batched_requests"] == 6


# the options beside the production path, at fs2 + r8 (head, pooled
# backbone): the bidirectional field, the cascade (single field, shifts:
# the sampler's path), both together, and the other warps
OPTIONS = {
    "bidir": dict(flow_bidir=True),
    "cascade1": dict(flow_cascade=1),
    "pyramid": dict(warp_impl="pyramid"),
    "gather4": dict(warp_impl="gather4"),
    "patch": dict(warp_impl="patch"),
    "bidir_cascade2": dict(flow_bidir=True, flow_cascade=2),
}
_OPTION_VARIABLES = {}


def option_variables(kw):
    """The Flax variables of config ``kw`` (drawn once per config)."""
    key = tuple(sorted(kw.items()))
    if key not in _OPTION_VARIABLES:
        _OPTION_VARIABLES[key] = random_variables(kw, HW)
    return _OPTION_VARIABLES[key]


@pytest.mark.parametrize("option", list(OPTIONS))
def test_flow_options_match_flax(option):
    # motion (field and mask), sample_parts at t = 0.25 and 0.5 (one time
    # per batch item) and forward against Flax apply, in f32: 1e-4, as
    # test_motion_sample_parts_and_forward_match_flax
    kw = dict(FLOW["fs2_r8"], **OPTIONS[option])
    variables = option_variables(kw)
    jmodel = j_build(JConfig(**kw), jnp.float32)
    f1, f2 = _frames()
    t = np.array([0.25, 0.5], np.float32)

    def run(v, a, b, tt):
        flow, mask = jmodel.apply(v, a, b, method="motion")
        parts = jmodel.apply(v, a, b, flow, mask, tt, method="sample_parts")
        return flow, mask, parts, jmodel.apply(v, a, b, tt)

    jflow, jmask, jparts, jout = jax.jit(run)(variables, f1, f2, t)
    model = _port(kw, variables)
    with torch.inference_mode():
        x1, x2, tt = _nchw(f1), _nchw(f2), torch.from_numpy(t)
        flow, mask = model.motion(x1, x2)
        parts = model.sample_parts(x1, x2, flow, mask, tt)
        out = model(x1, x2, tt)
    nf = 4 if kw.get("flow_bidir") else 2
    assert tuple(flow.shape) == (2, nf, *HW)
    close = dict(rtol=0, atol=1e-4)
    np.testing.assert_allclose(_nhwc(flow), np.asarray(jflow), **close)
    np.testing.assert_allclose(_nhwc(mask), np.asarray(jmask), **close)
    for got, want in zip(parts, jparts):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), **close)
    np.testing.assert_allclose(_nhwc(out), np.asarray(jout), **close)


@pytest.mark.parametrize("option", ["bidir", "cascade1", "pyramid"])
def test_flow_option_engines_match_jax(option, monkeypatch):
    # uint8 within 1 LSB of the JAX engine (f32, its XLA route on the CPU);
    # the wrappers' calls counted: the sampler only where the config is
    # the single-field shifts warp, the head once per sample
    from ai_based_frame_interpolation_torch.models import flow as t_flow
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        config_eligible)

    kw = dict(FLOW["fs2_r8"], **OPTIONS[option])
    variables = option_variables(kw)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    calls = {"sample_fused": 0, "refine_head": 0}
    for name in calls:
        def counted(*a, _fn=getattr(t_flow, name), _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(t_flow, name, counted)
    f1, f2 = _u8_pairs(2, 30, 44, seed=9)
    _within_1lsb(teng.interpolate_batch(f1, f2),
                 jeng.interpolate_batch(f1, f2))
    fused = config_eligible(TConfig(**kw))
    assert fused == (option == "cascade1")
    assert calls == {"sample_fused": int(fused), "refine_head": 1}
    assert len(teng.interpolate_at(f1[0], f2[0], [0.25, 0.6])) == 2
    assert calls == {"sample_fused": 3 * int(fused), "refine_head": 3}


@pytest.mark.parametrize("extra", [dict(space_to_depth=2),
                                   dict(flow_scale=0)])
def test_invalid_flow_configs_raise_value_error(extra):
    with pytest.raises(ValueError):
        t_build(TConfig(**dict(FLOW["fs2_r8"], **extra)))
