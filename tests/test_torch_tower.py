"""The port's tower family vs the Flax tower, on the CPU.

Weights are drawn from numpy (``test_torch_unet.random_variables``),
carried into the port through ``models/bridge.py`` and run in f32 on both
sides. ``forward``, ``encode`` and ``decode`` agree within 1e-4 absolute:
the same f32 convolutions summed in another order, a few ulp of values of
order 1-10 (``tests/test_torch_unet.py``'s bound). The engines' uint8
streams agree within 1 LSB, the repo's cross-program tolerance.
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
    fold_batchnorm as t_fold)
from ai_based_frame_interpolation_torch.ops.refine import refine_head
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.models.unet import (
    fold_batchnorm as j_fold)
from test_torch_unet import random_variables
from test_torch_video import check_stream, clip

TOWER = dict(arch="tower", base_width=8, depth=2)
# (config, frame size): the plain tower (s2d 1, align-corners decoder); the
# streaming option (slim decoder, s2d 2, full-resolution head, half-pixel
# decoder), at a size whose pooling floors, so the decoder pads its skips;
# a time-conditioned tower with its head at refine_factor 2
CASES = {
    "plain": (TOWER, (32, 40)),
    "slim_s2d_head": (dict(TOWER, space_to_depth=2, slim_decoder=True,
                           refine_width=8, residual=True,
                           upsample="half_pixel"), (36, 40)),
    "time_head_factor2": (dict(TOWER, space_to_depth=2, time_conditioned=True,
                               refine_width=8, refine_factor=2), (36, 40)),
}
ATOL = 1e-4


def _frames(hw, n=2, seed=1):
    gen = np.random.default_rng(seed)
    return [gen.uniform(-1, 1, (n, *hw, 1)).astype(np.float32)
            for _ in range(2)]


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.permute(0, 2, 3, 1).numpy()


def _port(kw, variables, folded=False):
    model = t_build(TConfig(**kw), torch.float32, folded=folded)
    model.load_state_dict(flax_to_state_dict(variables))
    model.eval()
    model.pack_head()
    return model


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("folded", [False, True])
def test_forward_encode_decode_match_flax(case, folded):
    kw, hw = CASES[case]
    variables = random_variables(kw, hw)
    jmodel = j_build(JConfig(**kw), jnp.float32, folded=folded)
    if folded:
        variables = jax.tree.map(np.asarray, j_fold(variables))
    f1, f2 = _frames(hw)
    t = np.array([0.3, 0.7], np.float32) if kw.get("time_conditioned") \
        else None

    @jax.jit
    def flax_all(v, a, b, t):
        fa = jmodel.apply(v, a, train=False, method="encode")
        fb = jmodel.apply(v, b, train=False, method="encode")
        dec = jmodel.apply(v, fa, fb, a, b, t=t, train=False,
                           method="decode")
        return fa, dec, jmodel.apply(v, a, b, t=t, train=False)

    want_feats, want_dec, want = flax_all(variables, f1, f2, t)
    model = _port(kw, variables, folded)
    tt = None if t is None else torch.from_numpy(t)
    with torch.inference_mode():
        a, b = _nchw(f1), _nchw(f2)
        feats = model.encode(a)
        dec = model.decode(feats, model.encode(b), a, b, t=tt)
        out = model(a, b, t=tt)
    assert len(feats) == len(want_feats) == kw["depth"] + 1
    for g, w in zip(feats, want_feats):
        np.testing.assert_allclose(_nhwc(g), np.asarray(w), rtol=0, atol=ATOL)
    for g in (dec, out):
        assert _nhwc(g).shape == want.shape == (2, *hw, 1)
        np.testing.assert_allclose(_nhwc(g), np.asarray(want), rtol=0,
                                   atol=ATOL)
    np.testing.assert_allclose(np.asarray(want_dec), np.asarray(want),
                               rtol=0, atol=1e-6)


def test_bridge_maps_the_tower_and_rejects_unknown_keys():
    kw, hw = CASES["slim_s2d_head"]
    variables = random_variables(kw, hw)
    state = flax_to_state_dict(variables)
    model = t_build(TConfig(**kw), torch.float32)
    assert {k: tuple(v.shape) for k, v in state.items()} == \
        {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k.split(".")[0] for k in state} == {
        "encoder", "decoder", "refine1", "refine2", "refine_out"}
    assert "decoder.proj0.weight" in state and "decoder.outc.bias" in state
    params = variables["params"]
    bogus = {"kernel": np.zeros((1, 1, 1, 1))}
    for bad, name in (
            (dict(params, decoder=dict(params["decoder"], bogus=bogus)),
             "decoder/bogus"),
            (dict(params, encoder=dict(params["encoder"],
                                       up1=params["decoder"]["up1"])),
             "encoder/up1")):
        with pytest.raises(KeyError, match=name):
            flax_to_state_dict({"params": bad,
                                "batch_stats": variables["batch_stats"]})


def test_fold_batchnorm_folds_the_tower_as_jax():
    kw, hw = CASES["slim_s2d_head"]
    variables = random_variables(kw, hw)
    want = flax_to_state_dict(jax.tree.map(np.asarray, j_fold(variables)))
    got = t_fold(flax_to_state_dict(variables))
    assert set(got) == set(want)
    assert not any(".bn" in k for k in got)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


def test_full_resolution_head_goes_through_the_kernel_wrapper(monkeypatch):
    """At refine_factor 1 the tower's head is ``refine_head`` with the
    weights packed once (the w64/w16 kernels on the card); at another
    factor the plain head."""
    calls = []

    def spy(*args, **kwargs):
        calls.append(args[4] if len(args) > 4 else kwargs.get("packed"))
        return refine_head(*args, **kwargs)

    monkeypatch.setattr("ai_based_frame_interpolation_torch.models.unet."
                        "refine_head", spy)
    f1, f2 = (_nchw(f) for f in _frames((32, 32)))
    for case, launches in (("slim_s2d_head", 1), ("time_head_factor2", 0)):
        kw, hw = CASES[case]
        model = _port(kw, random_variables(kw, hw))
        calls.clear()
        with torch.inference_mode():
            model(f1, f2)
        assert len(calls) == launches
        assert all(p is model.packed_head is not None for p in calls)


@pytest.fixture(scope="module")
def tower_engines():
    kw = CASES["slim_s2d_head"][0]
    variables = random_variables(kw, (32, 48))
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    return jeng, teng


@pytest.mark.parametrize("batch_pairs", [2, 5])
def test_tower_stream_matches_jax_and_pairwise(tower_engines, batch_pairs):
    jeng, teng = tower_engines
    frames = clip(6)
    got = list(teng.interpolate_video_frames(iter(frames), 2, batch_pairs))
    want = list(jeng.interpolate_video_frames(iter(frames), 2, batch_pairs))
    assert len(got) == 11
    check_stream(got, want, {2 * i: f for i, f in enumerate(frames)})
    # the shared encode gives the pairwise midpoints
    pairwise = teng.interpolate_batch(np.stack(frames[:-1]),
                                      np.stack(frames[1:]))
    check_stream(got[1::2], list(pairwise), {})


def test_tower_4x_takes_the_pair_function(tower_engines):
    jeng, teng = tower_engines
    frames = clip(3)
    got = list(teng.interpolate_video_frames(iter(frames), 4, 2))
    want = list(jeng.interpolate_video_frames(iter(frames), 4, 2))
    assert len(got) == 9
    check_stream(got, want, {4 * i: f for i, f in enumerate(frames)})


@pytest.mark.cuda
def test_tower_stream_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the tower's head kernel is CUDA "
                    "only")
    kw = dict(CASES["slim_s2d_head"][0], refine_width=64)
    eng = TEngine.random_init(TConfig(**kw), seed=0)
    frames = clip(7, (64, 96))
    before = refine_head.routes["w64/w64/bfloat16"]
    got = list(eng.interpolate_video_frames(iter(frames), 2, 3))
    assert refine_head.routes["w64/w64/bfloat16"] == before + 2
    want = eng.interpolate_batch(np.stack(frames[:-1]), np.stack(frames[1:]))
    check_stream(got[1::2], list(want), {})
