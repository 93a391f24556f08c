"""The port's option core (``models/core_t.py``) and the engine's
``core_impl`` routing vs the JAX package, on the CPU.

The core is held against the Flax forward (``model.apply(...,
skip_refine=True)``) on bridged folded weights at ``tests/test_core_t.py``'s
geometry (64x1024, s2d 2, base 8) and bound (atol 0.08, rtol 0.05: bf16
sums in another order through a depth-4 U-Net), with the kernels' plain
versions standing in for the kernels; the JAX package's own
``tests/test_core_t.py`` pins its Pallas core to the same Flax forward. The
engines agree within 1 uint8 LSB, the repo's cross-program tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.models import build_model as t_build
from ai_based_frame_interpolation_torch.models import core_t
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.ops.dconv_fused import (
    check_packed, double_conv_fused, up_double_conv_fused)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models import core_t as j_core_t
from ai_based_frame_interpolation_tpu.models.unet import (
    fold_batchnorm as j_fold)
from test_torch_unet import random_variables

H, W = 64, 1024
CORE = dict(space_to_depth=2, base_width=8, refine_width=16, residual=True)
CPU = jax.devices("cpu")[0]

# tests/test_core_t.py:88-103: (config, height, width)
ELIGIBILITY = [
    (dict(space_to_depth=4, base_width=64, refine_width=64, residual=True),
     1088, 1920),
    (dict(space_to_depth=4, base_width=64, refine_width=64, residual=True),
     2176, 3840),
    (dict(space_to_depth=4, base_width=64, refine_width=64, residual=True),
     768, 1280),
    (dict(space_to_depth=4, base_width=64, refine_width=64, residual=True),
     256, 256),
    (dict(space_to_depth=1), 1088, 1920),
    (dict(space_to_depth=4, time_conditioned=True), 1088, 1920),
    (dict(space_to_depth=4, depth=3), 1088, 1920),
    (dict(arch="flow"), 1088, 1920),
    (dict(CORE), H, W),
    (dict(CORE, channels=3), H, W),
]


@pytest.mark.parametrize("kw,h,w", ELIGIBILITY)
def test_eligible_matches_jax(kw, h, w):
    assert core_t.eligible(TConfig(**kw), h, w) == \
        j_core_t.eligible(JConfig(**kw), h, w)


def _folded_variables(kw, seed=0):
    """Numpy-drawn Flax variables (BatchNorm statistics included), folded."""
    return jax.tree.map(np.asarray, j_fold(random_variables(kw, (64, 64),
                                                             seed)))


def _frames(c, seed=7):
    gen = np.random.default_rng(seed)
    return [gen.uniform(-1, 1, (1, H, W, c)).astype(np.float32)
            for _ in range(2)]


@pytest.mark.parametrize("kw", [
    dict(CORE, upsample="half_pixel"),
    dict(CORE, upsample="align_corners"),
    dict(CORE, upsample="half_pixel", residual=False),
    dict(CORE, upsample="align_corners", residual=False),
    dict(CORE, channels=3),
], ids=["half_pixel", "align_corners", "half_pixel_no_residual",
        "align_corners_no_residual", "rgb"])
def test_forward_pre_refine_matches_flax(kw):
    variables = _folded_variables(kw)
    f1, f2 = _frames(kw.get("channels", 1))
    jmodel = j_build(JConfig(**kw), folded=True)
    with jax.default_device(CPU):
        want = np.asarray(jax.jit(lambda v, a, b: jmodel.apply(
            v, a, b, train=False, skip_refine=True))(variables, f1, f2))
    model = t_build(TConfig(**kw), torch.bfloat16, folded=True)
    model.load_state_dict(flax_to_state_dict(variables))
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2)).to(  # noqa: E731
        torch.bfloat16)
    with torch.inference_mode():
        got = core_t.forward_pre_refine(model.eval(), nchw(f1), nchw(f2))
    assert got.dtype == torch.float32 and tuple(got.shape) == (
        1, kw.get("channels", 1), H, W)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               atol=0.08, rtol=0.05)


@pytest.mark.parametrize("upsample", ["half_pixel", "align_corners"])
def test_engine_packs_what_each_level_launches_with(upsample):
    """The weights the engine packs once (``pack_core``) pass the check
    each level's kernel call makes on the card: the encoder and, with the
    align-corners decoder, up3 and up4 as double convs of the concat (no
    split); with the half-pixel decoder, up3 and up4 as up blocks split at
    the skip's channels."""
    eng = TEngine.random_init(TConfig(**CORE, upsample=upsample),
                              device="cpu", core_impl="pallas")
    packed, u = eng.model.packed_core, eng.model.unet
    skips = {"up3": u.down1.conv.conv2.out_channels,
             "up4": u.inc.conv2.out_channels}
    for name, dc in (("inc", u.inc), ("down1", u.down1.conv),
                     ("down2", u.down2.conv), ("up3", u.up3.conv),
                     ("up4", u.up4.conv)):
        w1, w2 = dc.conv1.weight, dc.conv2.weight
        cin = int(w1.shape[1])
        if name in skips and upsample == "half_pixel":
            c0 = skips[name]
            check_packed(packed[name], w1, w2, c0, cin - c0, c0)
        else:
            check_packed(packed[name], w1, w2, cin, 0, None)


def _u8_pairs(n, seed=3):
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    base = 127 + 80 * np.sin(x / 9.0) * np.cos(y / 7.0)
    f1 = np.stack([np.clip(base + gen.normal(0, 12, base.shape), 0, 255)
                   for _ in range(n)]).astype(np.uint8)[..., None]
    return f1, np.roll(f1, 4, axis=2)


def _within_1lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1


def test_engine_pallas_core_matches_jax_and_xla_route():
    """The port engine on the option core (``core_impl="pallas"``, the
    plain versions on the CPU) within 1 LSB of the JAX engine and of the
    port's default route, on the same folded weights, f32."""
    variables = _folded_variables(CORE, seed=1)
    jeng = JEngine(j_build(JConfig(**CORE), jnp.float32, folded=True),
                   variables, compute_dtype=jnp.float32)
    make = lambda impl: TEngine.from_flax_variables(  # noqa: E731
        variables, TConfig(**CORE), compute_dtype=torch.float32,
        device="cpu", core_impl=impl)
    teng, xeng = make("pallas"), make("xla")
    f1, f2 = _u8_pairs(2)
    x = torch.zeros(2, 1, H, W)
    assert teng._core_t_ok(x) and not xeng._core_t_ok(x)
    assert teng.model.packed_core is not None and xeng.model.packed_core is None
    got = teng.interpolate_batch(f1, f2)
    _within_1lsb(got, jeng.interpolate_batch(f1, f2))
    _within_1lsb(got, xeng.interpolate_batch(f1, f2))


def test_engine_pallas_core_matches_xla_route_bf16():
    """The same in the production dtype: the option core's uint8 output
    within 1 LSB of the default route on the same weights."""
    eng = {impl: TEngine.random_init(TConfig(**CORE), seed=2, device="cpu",
                                     core_impl=impl)
           for impl in ("pallas", "xla")}
    f1, f2 = _u8_pairs(1, seed=4)
    _within_1lsb(eng["pallas"].interpolate_batch(f1, f2),
                 eng["xla"].interpolate_batch(f1, f2))


def test_core_impl_routing():
    """The default route stays ``"xla"`` (as the JAX engine's,
    ``tests/test_core_t.py``); ``"auto"`` takes the core only on the card;
    ``"pallas"`` raises where the core does not apply; the CPU route
    launches no kernel."""
    cfg = TConfig(**CORE)
    assert TEngine.random_init(cfg, device="cpu").core_impl == "xla"
    x = torch.zeros(1, 1, H, W)
    assert not TEngine.random_init(cfg, device="cpu",
                                   core_impl="auto")._core_t_ok(x)
    eng = TEngine.random_init(cfg, device="cpu", core_impl="pallas")
    with pytest.raises(ValueError, match="core_impl='pallas'"):
        eng._core_t_ok(torch.zeros(1, 1, 64, 256))        # lane ratio 2x
    unfolded = TEngine.random_init(cfg, device="cpu", fold=False,
                                   core_impl="pallas")
    with pytest.raises(ValueError, match="core_impl='pallas'"):
        unfolded._core_t_ok(x)
    with pytest.raises(ValueError, match="core_impl"):
        TEngine.random_init(cfg, device="cpu", core_impl="cudnn")
    before = (double_conv_fused.launches, up_double_conv_fused.launches)
    f1, f2 = _u8_pairs(1, seed=5)
    eng.interpolate_batch(f1, f2)
    assert (double_conv_fused.launches, up_double_conv_fused.launches) == \
        before
