"""The port's evaluation path vs the JAX package, on the CPU: the PNG codec
and image loading against OpenCV, the triplet index, the fixture, the
baselines, ``evaluate_model`` on bridged weights, and the text reports.

Tolerances:

- PNG decode, gray conversion, the fixture, the triplet index and the
  baselines: exact;
- ``load_image`` with a resize: 1 LSB (the port resizes in f32 and
  rounds; cv2 uses 11-bit fixed-point taps);
- ``linear``/``optical_flow`` metrics: PSNR 1e-4 dB, SSIM 1e-5 (the same
  predictions; f32 metrics summed in another order);
- ``unet``: predictions within 1 LSB (the repo's cross-program
  tolerance), PSNR within 1e-3 dB and SSIM within 2e-4. A 1-LSB change on
  one pixel of a 64x64 frame moves the MSE by at most 511/4096, about 1e-5
  dB at these MSEs; the SSIM of a random-weight prediction against its
  target is low (about 0.3), where the covariance term cancels most, and
  the port and JAX measured 2.1e-5 apart on identical predictions, so the
  bound is the repo's cross-route SSIM bound, 2e-4.
"""

import csv
import io
import json
import os
import struct
import zlib

import cv2
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.data import synthetic as t_syn
from ai_based_frame_interpolation_torch.data import triplets as t_tri
from ai_based_frame_interpolation_torch.eval import report as t_report
from ai_based_frame_interpolation_torch.eval.harness import (
    evaluate_model as t_evaluate)
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.ops import flow as t_flow
from ai_based_frame_interpolation_torch.ops.image import (
    load_image, save_image)
from ai_based_frame_interpolation_torch.ops.png import (
    decode_png, encode_png, png_from_scanlines)
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.data import synthetic as j_syn
from ai_based_frame_interpolation_tpu.data import triplets as j_tri
from ai_based_frame_interpolation_tpu.eval import report as j_report
from ai_based_frame_interpolation_tpu.eval.harness import (
    evaluate_model as j_evaluate)
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from ai_based_frame_interpolation_tpu.ops import flow as j_flow
from test_torch_unet import random_variables

FILTERS = ["NONE", "SUB", "UP", "AVG", "PAETH"]


def _image(h, w, c, seed=0):
    """A smooth pattern with noise, so each filter sees real predictions."""
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = 127 + 100 * np.sin(x / 9.0) * np.cos(y / 7.0)
    return np.clip(base[..., None] + gen.normal(0, 4, (h, w, c)), 0,
                   255).astype(np.uint8)


def _cv2_rgb(img):
    """cv2's BGR(A) array -> file order (RGB(A))."""
    return img[..., [2, 1, 0] + ([3] if img.shape[-1] == 4 else [])]


@pytest.mark.parametrize("flt", FILTERS + ["ALL_FILTERS"])
def test_png_decoder_matches_cv2(tmp_path, flt):
    flag = getattr(cv2, "IMWRITE_PNG_" + (flt if flt == "ALL_FILTERS"
                                          else "FILTER_" + flt))
    for c in (1, 3, 4):
        img = _image(24, 30, c, seed=c)
        path = str(tmp_path / f"c{c}.png")
        assert cv2.imwrite(path, img[..., 0] if c == 1 else img,
                           [cv2.IMWRITE_PNG_FILTER, flag])
        with open(path, "rb") as f:
            got = decode_png(f.read())
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = want[..., None] if want.ndim == 2 else _cv2_rgb(want)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        # gray conversion bit-exact to cv2 (libpng's fixed-point weights)
        assert np.array_equal(load_image(path, grayscale=True),
                              cv2.imread(path, cv2.IMREAD_GRAYSCALE)[..., None])
        assert np.array_equal(load_image(path, grayscale=False),
                              cv2.imread(path, cv2.IMREAD_COLOR)[..., ::-1])


def _gray_alpha_png(img):
    """A gray+alpha PNG (cv2 cannot write one), filter 0."""
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           img.reshape(h, 2 * w)], 1)
    return png_from_scanlines(rows, w, 2)


def test_png_gray_alpha_and_encoder_round_trip(tmp_path):
    ga = _image(10, 12, 2)
    path = str(tmp_path / "ga.png")
    with open(path, "wb") as f:
        f.write(_gray_alpha_png(ga))
    assert np.array_equal(decode_png(_gray_alpha_png(ga)), ga)
    assert np.array_equal(load_image(path),
                          cv2.imread(path, cv2.IMREAD_GRAYSCALE)[..., None])
    for c in (1, 3):
        img = _image(17, 23, c, seed=5)
        path = str(tmp_path / f"rt{c}.png")
        save_image(path, img)
        assert np.array_equal(decode_png(encode_png(img)), img)
        assert np.array_equal(load_image(path, grayscale=(c == 1)), img)
        want = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        want = want[..., None] if want.ndim == 2 else want[..., ::-1]
        assert np.array_equal(want, img)


def test_png_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    # other formats go through OpenCV where it is installed; without it a
    # JPEG raises naming OpenCV and the ROADMAP, on reading and on writing
    path = str(tmp_path / "frame.jpg")
    assert cv2.imwrite(path, _image(6, 8, 1)[..., 0])
    assert np.array_equal(load_image(path),
                          cv2.imread(path, cv2.IMREAD_GRAYSCALE)[..., None])
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    with pytest.raises(ImportError, match="OpenCV.*ROADMAP"):
        load_image(path)
    with pytest.raises(ImportError, match="OpenCV.*ROADMAP"):
        save_image(path, _image(6, 8, 1))
    data = bytearray(encode_png(_image(4, 4, 1)))
    data[24] = 16                                   # bit depth 16
    data[29:33] = struct.pack(">I", zlib.crc32(bytes(data[12:29])))
    with pytest.raises(NotImplementedError):
        decode_png(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        decode_png(bytes(data[:30]) + b"\0" + bytes(data[31:]))
    rows = np.zeros((3, 5), np.uint8)
    rows[2, 0] = 5                                  # no such filter
    with pytest.raises(ValueError, match="scanline 2 has unknown filter 5"):
        decode_png(png_from_scanlines(rows, 4, 1))


@pytest.mark.parametrize("c", [1, 3])
def test_load_image_resize_within_1_lsb_of_cv2(tmp_path, c):
    img = _image(45, 61, c, seed=7)
    path = str(tmp_path / "f.png")
    cv2.imwrite(path, img[..., 0] if c == 1 else img[..., ::-1])
    for size in [(32, 40), (90, 122), (64, 64), (45, 30), (22, 30)]:
        got = load_image(path, grayscale=(c == 1), size=size)
        src = cv2.imread(path, cv2.IMREAD_GRAYSCALE if c == 1
                         else cv2.IMREAD_COLOR)
        want = cv2.resize(src, (size[1], size[0]),
                          interpolation=cv2.INTER_LINEAR)
        want = want[..., None] if c == 1 else want[..., ::-1]
        assert got.shape == want.shape == (*size, c)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1


def test_fixture_triplets_and_baselines_match_jax(tmp_path):
    for kw in (dict(), dict(channels=3, radius=10, step=7, seed=3)):
        assert np.array_equal(t_syn.moving_circle_frames(4, 32, 40, **kw),
                              j_syn.moving_circle_frames(4, 32, 40, **kw))
    t_root, j_root = str(tmp_path / "t"), str(tmp_path / "j")
    t_syn.write_fixture_tree(t_root, num_videos=2, num_frames=4, height=24,
                             width=32)
    j_syn.write_fixture_tree(j_root, num_videos=2, num_frames=4, height=24,
                             width=32)
    os.makedirs(os.path.join(t_root, "empty_video"))
    open(os.path.join(t_root, "notes.txt"), "w").close()
    t_list, j_list = t_tri.scan_triplets(t_root), j_tri.scan_triplets(j_root)
    assert len(t_list) == 4
    strip = lambda ts, root: [(os.path.relpath(t.video_dir, root),  # noqa: E731
                               t.frame_t0, t.frame_t1, t.ground_truth,
                               t.video_name, t.triplet_id) for t in ts]
    assert strip(t_list, t_root) == strip(j_list, j_root)
    for a, b in zip(t_list, j_list):
        for pa, pb in zip(a.paths(), b.paths()):
            assert np.array_equal(load_image(pa),
                                  cv2.imread(pb, cv2.IMREAD_GRAYSCALE)[..., None])
        got = t_tri.load_triplet_arrays(a, 16, 20)
        assert all(g.shape == (16, 20, 1) for g in got)
    many = [j_tri.Triplet("v", f"{i}", "b", "c", triplet_id=i)
            for i in range(23)]
    for seed in (0, 5):
        assert t_tri.split_triplets(many, 0.3, seed) == \
            j_tri.split_triplets(many, 0.3, seed)
    f1, f2 = _image(32, 32, 1, seed=1), _image(32, 32, 1, seed=2)
    assert np.array_equal(t_flow.linear_midpoint(f1, f2),
                          j_flow.linear_midpoint(f1, f2))
    assert np.array_equal(t_flow.farneback_midpoint(f1, f2),
                          j_flow.farneback_midpoint(f1, f2))


@pytest.fixture(scope="module")
def evaluations(tmp_path_factory):
    """Both harnesses over the same JAX-written fixture (2 videos x 5
    frames at 64x64) with the same bridged weights, frames saved."""
    root = str(tmp_path_factory.mktemp("evalset"))
    j_syn.write_fixture_tree(root, num_videos=2, num_frames=5, height=64,
                             width=64)
    kw = dict(base_width=4)
    variables = random_variables(kw, (64, 64))
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    out = str(tmp_path_factory.mktemp("frames"))
    args = dict(test_dir=root, batch_size=4, height=64, width=64)
    return (j_evaluate(jeng, save_frames_dir=os.path.join(out, "j"), **args),
            t_evaluate(teng, save_frames_dir=os.path.join(out, "t"), **args),
            out)


def test_evaluate_model_matches_jax(evaluations):
    want, got, frames = evaluations
    assert got["methods"] == want["methods"] == list(j_report.METHOD_LABELS)
    assert got["num_triplets"] == want["num_triplets"] == 6
    tol = {"unet": (1e-3, 2e-4), "linear": (1e-4, 1e-5),
           "optical_flow": (1e-4, 1e-5)}
    for m in want["methods"]:
        for g, w in zip(got["results_by_method"][m],
                        want["results_by_method"][m], strict=True):
            assert set(g) == set(w)
            assert {k: g[k] for k in g if k not in ("psnr", "ssim")} == \
                {k: w[k] for k in w if k not in ("psnr", "ssim")}
            assert abs(g["psnr"] - w["psnr"]) <= tol[m][0]
            assert abs(g["ssim"] - w["ssim"]) <= tol[m][1]
        assert set(got["metrics_by_method"][m]) == {"psnr", "ssim"}
    names = sorted(os.listdir(os.path.join(frames, "j", "unet")))
    assert names == sorted(os.listdir(os.path.join(frames, "t", "unet")))
    for name in names:
        a = load_image(os.path.join(frames, "t", "unet", name)).astype(int)
        b = cv2.imread(os.path.join(frames, "j", "unet", name),
                       cv2.IMREAD_GRAYSCALE)[..., None].astype(int)
        assert int(np.abs(a - b).max()) <= 1


def test_evaluate_model_device_and_isolation(tmp_path, monkeypatch):
    root = str(tmp_path / "set")
    t_syn.write_fixture_tree(root, num_videos=1, num_frames=4, height=20,
                             width=24)
    bad = os.path.join(root, "video_00", "frame_003.png")
    with open(bad, "wb") as f:         # truncated: the second triplet fails
        f.write(b"\x89PNG\r\n\x1a\n")
    res = t_evaluate(None, test_dir=root, methods=("linear",), height=20,
                     width=24, device="cpu")
    assert res["methods"] == ["linear"] and res["num_triplets"] == 1
    assert res["results_by_method"]["linear"][0]["triplet_id"] == 0
    with pytest.raises(ValueError, match="engine"):
        t_evaluate(None, test_dir=root, methods=("unet",), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_evaluate(None, test_dir=root, methods=("linear",))


def test_reports_match_jax(evaluations, tmp_path):
    want, got, _ = evaluations
    for results in (want, got):
        t_lines, j_lines = [], []
        t_report.print_summary(results, log_fn=t_lines.append)
        j_report.print_summary(results, log_fn=j_lines.append)
        assert t_lines == j_lines
    paths = {}
    for name, mod in (("t", t_report), ("j", j_report)):
        paths[name] = (
            mod.save_json(got, str(tmp_path / name / "results.json")),
            mod.write_markdown_report(got, str(tmp_path / name / "report.md"),
                                      extra_notes="note"),
            mod.save_csv_summary(got, str(tmp_path / name / "summary.csv")))
    for t_path, j_path in zip(paths["t"], paths["j"]):
        with open(t_path) as f, open(j_path) as g:
            t_text, j_text = f.read(), g.read()
        if t_path.endswith(".csv"):
            pd.testing.assert_frame_equal(pd.read_csv(io.StringIO(t_text)),
                                          pd.read_csv(io.StringIO(j_text)))
            assert next(csv.reader(io.StringIO(t_text)))[0] == "method"
        assert t_text == j_text
    with open(paths["t"][0]) as f:
        assert json.load(f) == json.loads(json.dumps(got))
