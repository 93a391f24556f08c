"""The port's batch-packed U-Net core (``core_pack``) vs the JAX package's.

g batch items fold into the channel axis and every U-Net conv runs grouped
(``groups=g``) over the per-item weights repeated per group, as JAX's
``pack_batch``/``tile_params_packed`` do: the same per-item math. Weights
are drawn from numpy (BatchNorm statistics included), folded, and carried
into the port through ``models/bridge.py``. Tolerances: the layout helpers
bit for bit; the packed model 1e-5 against the unpacked port model (the
same convs over the same values, grouped) and 1e-4 against JAX's packed
model (f32 convs summed in another order, as ``test_torch_unet.py``);
engines within 1 LSB, the repo's cross-program tolerance, and bit for bit
where a dispatch runs unpacked.
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
from ai_based_frame_interpolation_torch.models.bridge import flax_to_state_dict
from ai_based_frame_interpolation_torch.models.unet import (
    grouped_concat, pack_batch, tile_params_packed, unpack_batch)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models import unet as j_unet
from test_torch_unet import random_variables

HW = (32, 32)
# the production shape (s2d, residual, head, half-pixel decoder) and the
# time-conditioned input (its t plane packed per group), at a tiny width
CASES = {
    "s2d_residual_head": dict(base_width=4, depth=2, space_to_depth=2,
                              residual=True, refine_width=4,
                              upsample="half_pixel"),
    "time_conditioned": dict(base_width=4, depth=2, time_conditioned=True),
}


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


@pytest.fixture(scope="module")
def folded():
    """Each case's folded Flax variables, as numpy."""
    return {name: jax.tree.map(np.asarray, j_unet.fold_batchnorm(
        random_variables(kw, HW))) for name, kw in CASES.items()}


def test_pack_unpack_round_trip_and_jax_layout():
    # the port's NCHW packing is JAX's NHWC packing transposed
    x = np.random.default_rng(0).random((6, 4, 5, 3), dtype=np.float32)
    for g in (1, 2, 3, 6):
        got = pack_batch(_nchw(x), g)
        np.testing.assert_array_equal(
            _nhwc(got), np.asarray(j_unet.pack_batch(jnp.asarray(x), g)))
        assert torch.equal(unpack_batch(got, g), _nchw(x))


def test_grouped_concat_matches_jax():
    rng = np.random.default_rng(1)
    g = 2
    a = rng.random((2, 4, 4, 6), dtype=np.float32)
    b = rng.random((2, 4, 4, 10), dtype=np.float32)
    want = j_unet.grouped_concat([jnp.asarray(a), jnp.asarray(b)], g)
    got = grouped_concat([_nchw(a), _nchw(b)], g)
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want))


@pytest.mark.parametrize("case", list(CASES))
def test_packed_model_matches_unpacked_and_jax(case, folded):
    kw = CASES[case]
    variables = folded[case]
    g = 2
    rng = np.random.default_rng(2)
    f1, f2 = (rng.uniform(-1, 1, (4, *HW, 1)).astype(np.float32)
              for _ in range(2))
    t = np.array([0.2, 0.4, 0.6, 0.9], np.float32)
    extra = {"t": t} if kw.get("time_conditioned") else {}
    jmodel = j_build(JConfig(**kw), jnp.float32, folded=True, pack=g)
    want = jax.jit(lambda v, a, b, **e: jmodel.apply(v, a, b, train=False,
                                                     **e))(
        j_unet.tile_params_packed(variables, g), f1, f2, **extra)
    state = flax_to_state_dict(variables)
    base = t_build(TConfig(**kw), torch.float32, folded=True)
    base.load_state_dict(state)
    packed = t_build(TConfig(**kw), torch.float32, folded=True, pack=g)
    packed.load_state_dict(tile_params_packed(state, g))
    assert packed.unet.inc.conv1.groups == g
    targs = {k: torch.from_numpy(v) for k, v in extra.items()}
    with torch.inference_mode():
        got = packed.eval()(_nchw(f1), _nchw(f2), **targs)
        ref = base.eval()(_nchw(f1), _nchw(f2), **targs)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), rtol=0,
                               atol=1e-4)


def _pairs(n, seed):
    rng = np.random.default_rng(seed)
    f1 = rng.integers(0, 256, (n, *HW, 1), dtype=np.uint8)
    return f1, rng.integers(0, 256, f1.shape, dtype=np.uint8)


def test_engine_core_pack_matches_jax(folded):
    kw = CASES["s2d_residual_head"]
    variables = folded["s2d_residual_head"]
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32, folded=True),
                   variables, compute_dtype=jnp.float32, core_pack=2)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu", core_pack=2)
    assert teng._use_pack(4) and jeng._use_pack(4)
    f1, f2 = _pairs(4, seed=3)
    got = teng.interpolate_batch(f1, f2)
    assert ("packed_core", 2) in teng._fn_cache
    want = jeng.interpolate_batch(f1, f2)
    assert got.shape == want.shape and got.dtype == np.uint8
    assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


@pytest.mark.parametrize("why", ["odd_batch", "unfolded",
                                 "indivisible_max_dispatch_batch"])
def test_core_pack_runs_unpacked_where_jax_does(why, folded):
    # JAX's _use_pack conditions: these dispatches run the unpacked core,
    # bit for bit the engine without core_pack
    kw = CASES["s2d_residual_head"]
    variables = folded["s2d_residual_head"]
    opts = dict(compute_dtype=torch.float32, device="cpu")
    if why == "unfolded":
        variables = random_variables(kw, HW)
        opts["fold"] = False
    ref = TEngine.from_flax_variables(variables, TConfig(**kw), **opts)
    eng = TEngine.from_flax_variables(variables, TConfig(**kw), core_pack=2,
                                      **opts)
    n = 3 if why == "odd_batch" else 4
    if why == "indivisible_max_dispatch_batch":
        ref.max_dispatch_batch = eng.max_dispatch_batch = 3
    assert not eng._use_pack(n)
    f1, f2 = _pairs(n, seed=4)
    np.testing.assert_array_equal(eng.interpolate_batch(f1, f2),
                                  ref.interpolate_batch(f1, f2))
    assert ("packed_core", 2) not in eng._fn_cache


def test_core_pack_and_the_option_core():
    # a packed dispatch never takes the option core: "auto" packs,
    # "pallas" raises naming both; an odd batch still takes the core
    kw = dict(space_to_depth=2, base_width=8, refine_width=16,
              residual=True, upsample="half_pixel")   # test_torch_core's
    with torch.device("meta"):
        model = t_build(TConfig(**kw), torch.float32)
    eng = TEngine(model, {k: torch.zeros_like(v, device="cpu")
                          for k, v in model.state_dict().items()},
                  compute_dtype=torch.float32, device="cpu", core_pack=2,
                  core_impl="pallas")
    x = torch.zeros(2, 1, 64, 1024)
    with pytest.raises(ValueError, match="core_pack=2"):
        eng._core_t_ok(x)
    assert eng._core_t_ok(x[:1])
    eng.core_impl = "auto"
    assert not eng._core_t_ok(x)


def test_pack_needs_folded_weights_and_the_bilinear_decoder():
    with torch.device("meta"):
        with pytest.raises(ValueError, match="folded"):
            t_build(TConfig(base_width=4), pack=2)
        with pytest.raises(ValueError, match="bilinear"):
            t_build(TConfig(base_width=4, bilinear=False), folded=True,
                    pack=2)
        with pytest.raises(ValueError, match="U-Net family"):
            t_build(TConfig(arch="flow"), folded=True, pack=2)
    with pytest.raises(ValueError, match="folded"):
        tile_params_packed({"unet.inc.bn1.running_var": torch.ones(4)}, 2)
