"""The port's ``utils/`` (profiling and logging) against what
``tests/test_utils.py`` holds the JAX package's to; the small public
names (``models.MODEL_REGISTRY``, ``ops/image.py:preprocess_frames``)
against JAX's; and the image files the port's PNG codec does not read or
write, which go through OpenCV as in the JAX package (palette and 16-bit
PNGs read as JAX's ``load_image`` reads them, a JPEG written as JAX's
``save_image`` writes it)."""

import json
import logging
import struct
import sys
import time
import types
import zlib

import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.ops.image import (
    decode_image, load_image, preprocess_frames, save_image)
from ai_based_frame_interpolation_torch.ops.png import SIGNATURE, chunk
from ai_based_frame_interpolation_torch.utils.logging import (
    StageTimer, get_logger)
from ai_based_frame_interpolation_torch.utils import logging as fi_logging
from ai_based_frame_interpolation_torch.utils import profiling
from ai_based_frame_interpolation_torch.utils.profiling import (
    annotate, count, counters, device_memory_stats, totals, trace)


def test_stage_timer_accumulates():
    t = StageTimer()
    with t.stage("decode"):
        time.sleep(0.01)
    with t.stage("decode"):
        time.sleep(0.01)
    with t.stage("encode"):
        pass
    s = t.summary()
    assert s["decode"]["count"] == 2 and s["encode"]["count"] == 1
    assert s["decode"]["seconds"] >= 0.02
    lines = []
    t.log_summary(lines.append)
    assert "decode" in lines[0] and len(lines) == 2


def test_logger_singleton_and_its_level(monkeypatch):
    monkeypatch.setenv("FI_TPU_LOGLEVEL", "WARNING")
    a = get_logger("fi_torch_test")
    b = get_logger("fi_torch_test")
    assert a is b and a.handlers and a.level == logging.WARNING


def test_trace_noop_without_dir(monkeypatch):
    monkeypatch.delenv("FI_TPU_PROFILE_DIR", raising=False)
    with trace(None):
        pass


def test_trace_writes_a_chrome_trace_with_the_annotation(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("FI_TPU_PROFILE_DIR", str(tmp_path))
    with trace():
        with annotate("fi_region"):
            torch.ones(8).sum()
    (path,) = tmp_path.glob("trace_*.json")
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    assert "fi_region" in names


def test_spans_without_a_profiler_cost_one_flag_check(monkeypatch):
    """No profiler: ``annotate`` hands back one shared no-op context and
    ``count`` None, entering no ``record_function``, reading no clock and
    recording nothing."""
    def refused(*args, **kwargs):
        raise AssertionError("touched with no profiler running")

    profiling.reset()
    monkeypatch.setattr(torch.profiler, "record_function", refused)
    monkeypatch.setattr(fi_logging, "time",
                        types.SimpleNamespace(perf_counter_ns=refused))
    assert not torch.autograd.profiler._is_profiler_enabled
    first = annotate("engine.upload")
    assert first is annotate("engine.download")
    with first:
        pass
    assert count("engine.dispatches") is None
    assert totals() == {} and counters() == {}


def test_spans_under_a_profiler_and_a_second_session(tmp_path):
    """Under a profiler each span is a range on its timeline and adds to
    the totals, self seconds being the seconds less the children's; the
    counters; and a second session, ``trace``'s, reads only its own."""
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        count("engine.dispatches")
        with annotate("outer"):
            time.sleep(0.01)
            with annotate("inner"):
                time.sleep(0.005)
            with annotate("inner"):
                pass
        with annotate("alone"):
            pass
        count("engine.dispatches", 2)
    names = [ev.name() for ev in prof.profiler.kineto_results.events()]
    assert all(names.count(k) == n
               for k, n in (("outer", 1), ("inner", 2), ("alone", 1)))
    t = totals()
    assert {k: v["count"] for k, v in t.items()} == {
        "outer": 1, "inner": 2, "alone": 1}
    assert t["outer"]["seconds"] >= 0.015
    assert t["outer"]["self_seconds"] == pytest.approx(
        t["outer"]["seconds"] - t["inner"]["seconds"], abs=1e-9)
    assert t["inner"]["self_seconds"] == t["inner"]["seconds"]
    assert counters() == {"engine.dispatches": 3}
    with trace(str(tmp_path)):
        with annotate("second"):
            pass
    assert set(totals()) == {"second"} and counters() == {}


def test_device_memory_stats_asks_for_the_cpu_by_name(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_memory_stats()
    assert device_memory_stats(["cpu"]) == {"cpu": None}


def test_model_registry_matches_jax():
    from ai_based_frame_interpolation_torch.models import (
        MODEL_REGISTRY, build_model)
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_tpu.models import (
        MODEL_REGISTRY as J_REGISTRY)

    assert set(MODEL_REGISTRY) == set(J_REGISTRY)
    for arch, cls in MODEL_REGISTRY.items():
        assert cls.__name__ == J_REGISTRY[arch].__name__
        model = build_model(ModelConfig(arch=arch, base_width=8), torch.float32)
        assert type(model) is cls


@pytest.mark.parametrize("out_hw", [None, (24, 40)])
def test_preprocess_frames_matches_jax(out_hw):
    import jax.numpy as jnp

    from ai_based_frame_interpolation_tpu.ops.image import (
        preprocess_frames as j_pre)

    f = np.random.default_rng(0).integers(0, 256, (2, 32, 48, 3), np.uint8)
    want = np.asarray(j_pre(jnp.asarray(f), out_hw, jnp.float32))
    got = preprocess_frames(torch.from_numpy(f), out_hw, torch.float32)
    # the resize's f32 lerps in another order: test_torch_ops.py's bound
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert preprocess_frames(torch.from_numpy(f), out_hw).dtype == \
        torch.bfloat16


def _png(w, h, depth, ctype, raw: bytes, extra=b"") -> bytes:
    """A PNG of unfiltered scanlines ``raw`` (filter byte 0 per row)."""
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, 0)
    stride = len(raw) // h
    rows = b"".join(b"\0" + raw[i * stride:(i + 1) * stride]
                    for i in range(h))
    return (SIGNATURE + chunk(b"IHDR", ihdr) + extra +
            chunk(b"IDAT", zlib.compress(rows)) + chunk(b"IEND", b""))


def _undecoded_pngs():
    gen = np.random.default_rng(1)
    palette = gen.integers(0, 256, (6, 3), np.uint8)
    idx = gen.integers(0, 6, (5, 7), np.uint8)
    gray16 = gen.integers(0, 65536, (6, 9), np.uint16)
    return {
        "palette": _png(7, 5, 8, 3, idx.tobytes(),
                        chunk(b"PLTE", palette.tobytes())),
        "gray16": _png(9, 6, 16, 0, gray16.astype(">u2").tobytes()),
    }


@pytest.mark.parametrize("kind", ["palette", "gray16"])
def test_pngs_the_codec_does_not_read_load_as_jax_loads_them(kind, tmp_path):
    # OpenCV reads them as 8-bit, as JAX's load_image does (gray and RGB)
    pytest.importorskip("cv2")
    from ai_based_frame_interpolation_tpu.ops.image import (
        load_image as j_load)

    path = str(tmp_path / f"{kind}.png")
    with open(path, "wb") as f:
        f.write(_undecoded_pngs()[kind])
    for gray in (True, False):
        got = load_image(path, grayscale=gray)
        assert got.dtype == np.uint8 and got.shape[-1] == (1 if gray else 3)
        np.testing.assert_array_equal(got, j_load(path, grayscale=gray))


def test_without_opencv_those_pngs_raise_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    for data in _undecoded_pngs().values():
        with pytest.raises(ImportError, match="OpenCV"):
            decode_image(data)


def test_save_image_writes_other_formats_as_jax_does(tmp_path):
    # a JPEG through cv2.imwrite: the bytes JAX's save_image writes, and
    # cv2 reads it back
    cv2 = pytest.importorskip("cv2")
    from ai_based_frame_interpolation_tpu.ops.image import (
        save_image as j_save)

    img = np.random.default_rng(2).integers(0, 256, (16, 24, 3), np.uint8)
    for c in (1, 3):
        got, want = tmp_path / f"p{c}.jpg", tmp_path / f"j{c}.jpg"
        save_image(str(got), img[..., :c])
        j_save(str(want), img[..., :c])
        assert got.read_bytes() == want.read_bytes()
        back = cv2.imread(str(got), cv2.IMREAD_UNCHANGED)
        assert back.shape[:2] == (16, 24)


def test_the_sampler_names_shapes_beyond_its_grid():
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.ops import warp_fused

    cfg = ModelConfig(arch="flow")
    assert warp_fused.eligible(cfg, (1, 2 ** 22, 2, 1))
    assert not warp_fused.eligible(cfg, (1, 2 ** 22 + 1, 2, 1))
    assert not warp_fused.eligible(cfg, (1, 8, 2 ** 22 + 1, 3))
    assert not warp_fused.eligible(cfg, (1, 1, 8, 1))
