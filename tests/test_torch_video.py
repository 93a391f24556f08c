"""The port's video slice vs the JAX engine, on the CPU.

Both engines run in f32 on the same bridged weights (tiny models, 32x48
frames, module-scoped engines so JAX compiles each shape once) and the
same uint8 frames. Originals pass through bit for bit; in-betweens agree
within 1 LSB, the repo's cross-program tolerance. Also here: the host C
helpers against their numpy plain versions and JAX's ``ops/native``, the
``_file`` entry points through OpenCV, and ``core_impl`` assigned after
construction.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.config import VideoConfig as TVideo
from ai_based_frame_interpolation_torch.data.synthetic import (
    write_fixture_video)
from ai_based_frame_interpolation_torch.data.video import VideoReader
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.ops import native
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.config import VideoConfig as JVideo
from ai_based_frame_interpolation_tpu.data.synthetic import (
    write_fixture_video as j_write_fixture_video)
from ai_based_frame_interpolation_tpu.data.video import (
    VideoReader as JVideoReader)
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.ops import native as j_native
from test_torch_core import CORE, H as CORE_H, W as CORE_W
from test_torch_unet import CASES, random_variables

HW = (32, 48)
UNET = CASES["production"][0]
FLOW = dict(arch="flow", base_width=4, depth=2, flow_scale=2, refine_width=8,
            max_flow=8)


def _engines(kw):
    variables = random_variables(kw, HW)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    return jeng, teng


@pytest.fixture(scope="module")
def unet():
    return _engines(UNET)


@pytest.fixture(scope="module")
def flow():
    return _engines(FLOW)


def clip(n, hw=HW, seed=0):
    """``n`` gray frames of a pattern moving 3 px a frame, with noise."""
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    base = [127 + 80 * np.sin((x - 3 * i) / 5.0) * np.cos(y / 4.0)
            for i in range(n)]
    return [np.clip(b + gen.normal(0, 10, hw), 0, 255).astype(np.uint8)[
        ..., None] for b in base]


def check_stream(got, want, originals):
    """Same length; ``originals`` ({output index: input frame}) bit for
    bit on both sides; every other frame within 1 LSB."""
    assert len(got) == len(want)
    for k, frame in originals.items():
        assert np.array_equal(got[k], frame) and np.array_equal(want[k], frame)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        assert int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max()) <= 1


def test_video_config_matches_jax():
    assert TVideo() == TVideo(**vars(JVideo()))


@pytest.mark.parametrize("factor,batch_pairs", [(2, 2), (2, 5), (3, 2),
                                                (4, 5)])
def test_unet_video_frames_match_jax(unet, factor, batch_pairs):
    jeng, teng = unet
    frames = clip(6)
    got = list(teng.interpolate_video_frames(iter(frames), factor,
                                             batch_pairs))
    want = list(jeng.interpolate_video_frames(iter(frames), factor,
                                              batch_pairs))
    assert len(got) == 5 * factor + 1
    check_stream(got, want, {factor * i: f for i, f in enumerate(frames)})


def test_max_dispatch_batch_splits_a_stream_batch(unet):
    _, teng = unet
    frames = clip(6)
    whole = list(teng.interpolate_video_frames(iter(frames), 2, 5))
    seen = []
    inner = teng._build_pair_fn

    def counted(n_out, depth):
        fn = inner(n_out, depth)
        return lambda m, a, b: (seen.append(int(a.shape[0])), fn(m, a, b))[1]

    teng._build_pair_fn, teng.max_dispatch_batch = counted, 2
    teng._fn_cache.clear()
    try:
        split = list(teng.interpolate_video_frames(iter(frames), 2, 5))
    finally:
        del teng._build_pair_fn
        teng.max_dispatch_batch = None
        teng._fn_cache.clear()
    assert seen == [2, 2, 1]
    check_stream(split, whole, {2 * i: f for i, f in enumerate(frames)})


@pytest.mark.parametrize("rate,batch_pairs", [(2.5, 4), (0.5, 1), (2.4, 4),
                                              (2.4, 1)])
def test_flow_retime_matches_jax(flow, rate, batch_pairs):
    jeng, teng = flow
    frames = clip(6)
    got = list(teng.retime_video_frames(iter(frames), rate,
                                        batch_pairs=batch_pairs))
    want = list(jeng.retime_video_frames(iter(frames), rate,
                                         batch_pairs=batch_pairs))
    # output k sits at input time k / rate; an integer time is an original
    originals = {k: frames[round(k / rate)] for k in range(len(want))
                 if abs(k / rate - round(k / rate)) <= 1e-6}
    assert len(got) == int(5 * rate + 1e-6) + 1
    check_stream(got, want, originals)


def test_flow_video_frames_at_3x_match_jax(flow):
    jeng, teng = flow
    frames = clip(5)
    got = list(teng.interpolate_video_frames(iter(frames), 3, 3))
    want = list(jeng.interpolate_video_frames(iter(frames), 3, 3))
    check_stream(got, want, {3 * i: f for i, f in enumerate(frames)})


def test_short_streams_match_jax(unet, flow):
    # one frame passes through; no frame gives nothing
    one = clip(1)
    for (jeng, teng), run in (
            (unet, lambda e, f: e.interpolate_video_frames(iter(f), 2)),
            (flow, lambda e, f: e.interpolate_video_frames(iter(f), 3)),
            (flow, lambda e, f: e.retime_video_frames(iter(f), 2.5))):
        got, want = list(run(teng, one)), list(run(jeng, one))
        check_stream(got, want, {0: one[0]})
        assert list(run(teng, [])) == list(run(jeng, [])) == []


def test_validation_errors_match_jax(unet, flow):
    frames = clip(3)
    for eng in (*unet, *flow):
        with pytest.raises(ValueError, match="factor must be an integer"):
            list(eng.interpolate_video_frames(iter(frames), factor=1))
        with pytest.raises(ValueError, match="rate must be positive"):
            list(eng.retime_video_frames(iter(frames), 0.0))
    for eng in unet:
        assert not eng.supports_exact_time
        with pytest.raises(ValueError, match="retiming requires exact-time"):
            list(eng.retime_video_frames(iter(frames), 2.5))


def _stats(s):
    return {k: v for k, v in s.items()
            if k not in ("seconds", "frames_per_second")}


@pytest.fixture(scope="module")
def colour_clip(tmp_path_factory):
    """A colour MP4 of the moving circle (6 frames, 32x48), written by the
    port; JAX's writer gives the same decoded frames."""
    root = tmp_path_factory.mktemp("clip")
    path = write_fixture_video(str(root / "port.mp4"), num_frames=6,
                               height=HW[0], width=HW[1])
    jpath = j_write_fixture_video(str(root / "jax.mp4"), num_frames=6,
                                  height=HW[0], width=HW[1])
    got, want = list(VideoReader(path)), list(JVideoReader(jpath))
    assert len(got) == len(want) == 6
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    return path


def test_video_file_matches_jax(unet, colour_clip, tmp_path):
    # the gray model on a colour clip: the reader converts
    jeng, teng = unet
    outs = [str(tmp_path / f"{n}.mp4") for n in ("port", "jax")]
    got = teng.interpolate_video_file(colour_clip, outs[0], factor=2,
                                      batch_pairs=2)
    want = jeng.interpolate_video_file(colour_clip, outs[1], factor=2,
                                       batch_pairs=2)
    assert set(got) == set(want) and _stats(got) == _stats(want)
    assert got["output_frames"] == 11
    decoded = list(VideoReader(outs[0], grayscale=True))
    assert len(decoded) == 11 and decoded[0].shape == (*HW, 1)


def test_retime_video_file_matches_jax(flow, colour_clip, tmp_path):
    jeng, teng = flow
    outs = [str(tmp_path / f"{n}.mp4") for n in ("port", "jax")]
    got = teng.retime_video_file(colour_clip, outs[0], target_fps=75.0,
                                 batch_pairs=4)
    want = jeng.retime_video_file(colour_clip, outs[1], target_fps=75.0,
                                  batch_pairs=4)
    assert set(got) == set(want) and _stats(got) == _stats(want)
    assert got["output_frames"] == 13
    assert len(list(VideoReader(outs[0]))) == 13


def test_file_entry_points_raise_without_opencv(unet, flow, colour_clip,
                                                tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)     # import cv2 fails
    out = str(tmp_path / "out.mp4")
    with pytest.raises(ImportError, match="OpenCV"):
        unet[1].interpolate_video_file(colour_clip, out)
    with pytest.raises(ImportError, match="OpenCV"):
        flow[1].retime_video_file(colour_clip, out, target_fps=60.0)
    assert not os.path.exists(out)


def test_deadline_stops_a_video_job(unet, flow, colour_clip, tmp_path):
    out = str(tmp_path / "out.mp4")
    with pytest.raises(TimeoutError, match="exceeded its deadline after 0"):
        unet[1].interpolate_video_file(colour_clip, out, deadline=0.0)
    with pytest.raises(TimeoutError, match="exceeded its deadline after 0"):
        flow[1].retime_video_file(colour_clip, out, 60.0, deadline=0.0)


def test_linear_transition_frames_match_jax():
    f1, f2 = clip(2)
    got = TEngine.linear_transition_frames(f1, f2, 3)
    want = JEngine.linear_transition_frames(f1, f2, 3)
    assert len(got) == 3
    assert all(np.array_equal(g, w) for g, w in zip(got, want))


def test_core_impl_assigned_after_construction_packs_the_core():
    cfg = TConfig(**CORE)
    late = TEngine.random_init(cfg, seed=3, compute_dtype=torch.float32,
                               device="cpu")
    assert late.core_impl == "xla" and late.model.packed_core is None
    with pytest.raises(ValueError, match="core_impl"):
        late.core_impl = "cudnn"
    assert late.core_impl == "xla" and late.model.packed_core is None
    late.core_impl = "pallas"
    assert late.model.packed_core is not None
    built = TEngine.random_init(cfg, seed=3, compute_dtype=torch.float32,
                                device="cpu", core_impl="pallas")
    gen = np.random.default_rng(6)
    f1 = gen.integers(0, 256, (1, CORE_H, CORE_W, 1), dtype=np.uint8)
    f2 = np.roll(f1, 4, axis=2)
    assert late._core_t_ok(torch.zeros(1, 1, CORE_H, CORE_W))
    assert np.array_equal(late.interpolate_batch(f1, f2),
                          built.interpolate_batch(f1, f2))


def _u8(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape,
                                                dtype=np.uint8)


# (helper, its arguments): BGR frames; 4 frames; 3 originals and 2 pairs of
# 3 in-betweens (RGB)
HELPERS = [("bgr_to_gray", ((2, 5, 7, 3),)), ("bgr_to_rgb", ((2, 5, 7, 3),)),
           ("pack_pairs", ((4, 5, 7, 1),)),
           ("interleave", ((3, 5, 7, 3), (2, 3, 5, 7, 3)))]


@pytest.mark.parametrize("name,shapes", HELPERS, ids=[h[0] for h in HELPERS])
def test_host_helpers_match_plain_and_jax(name, shapes):
    a = [_u8(shape, seed) for seed, shape in enumerate(shapes)]
    got = getattr(native, name)(*a)
    for want in (getattr(native, f"{name}_reference")(*a),
                 getattr(j_native, name)(*a)):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype == np.uint8 and np.array_equal(g, w)


def test_host_helpers_check_shapes_as_jax():
    originals = np.zeros((3, 4, 4, 1), np.uint8)
    for mod in (native, j_native):
        with pytest.raises(ValueError, match="need 4 originals for 3 pairs, "
                                             "got 3"):
            mod.interleave(originals, np.zeros((3, 2, 4, 4, 1), np.uint8))
        with pytest.raises(ValueError, match="frame shape mismatch"):
            mod.interleave(originals, np.zeros((2, 1, 4, 5, 1), np.uint8))
        with pytest.raises(ValueError, match="need at least 2 frames"):
            mod.pack_pairs(originals[:1])
    with pytest.raises(ValueError, match="BGR"):
        native.bgr_to_gray(originals)


@pytest.mark.cuda
def test_video_streams_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the stream's pinned transfers "
                    "and the head kernel are CUDA only")
    eng = TEngine.random_init(TConfig(**UNET), seed=0)
    frames = clip(7, (64, 96))
    for factor in (2, 4):
        got = list(eng.interpolate_video_frames(iter(frames), factor, 2))
        assert len(got) == 6 * factor + 1
        for i, f in enumerate(frames):
            assert np.array_equal(got[factor * i], f)
        if factor == 2:
            want = eng.interpolate_batch(np.stack(frames[:-1]),
                                         np.stack(frames[1:]))
            du = np.abs(np.stack(got[1::2]).astype(np.int16) -
                        want.astype(np.int16))
            assert int(du.max()) <= 1
