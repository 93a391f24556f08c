"""The port's command line (``cli.py``) against the JAX package's, on the
CPU: the parser, and each subcommand on tiny models (base width 4, 32x32
frames, f32) with ``--device cpu``.

Tolerances: the PNGs ``infer`` writes, 1 LSB (the repo's cross-program
tolerance); the dataset's frames, 1 LSB (``moving_scene_frames``, as
``tests/test_torch_loader.py`` holds it); ``convert``'s arrays and
``info``'s lines on a ``.pth``: equal.
"""

import argparse
import os

import cv2
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch import cli as t_cli
from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.data.synthetic import (
    write_fixture_tree)
from ai_based_frame_interpolation_torch.ops.image import load_image, save_image
from ai_based_frame_interpolation_tpu import cli as j_cli
from test_torch_checkpoint_import import BASE, reference_state_dict

HW = ["--height", "32", "--width", "32"]
CPU = ["--device", "cpu"]


def _options(parser):
    """{subcommand: {option strings: (default, choices, required, nargs,
    const, type)}}, ``--device`` and ``-h`` left out."""
    sub = next(a for a in parser._actions
               if isinstance(a, argparse._SubParsersAction))
    out = {}
    for name, sp in sub.choices.items():
        out[name] = {tuple(a.option_strings): (
            a.default, a.choices, a.required, a.nargs, a.const,
            getattr(a.type, "__name__", a.type))
            for a in sp._actions
            if a.option_strings and a.dest not in ("help", "device")}
    return out


def test_the_parser_equals_jax_but_for_prog_and_device():
    t, j = t_cli.build_parser(), j_cli.build_parser()
    assert (t.prog, j.prog) == ("fi-torch", "fi-tpu")
    assert _options(t) == _options(j)
    sub = next(a for a in t._actions
               if isinstance(a, argparse._SubParsersAction))
    has_device = {name for name, sp in sub.choices.items()
                  if any(a.dest == "device" for a in sp._actions)}
    assert has_device == {"train", "infer", "video", "eval", "serve", "demo"}


def test_dataset_matches_jax(tmp_path, capsys):
    args = ["dataset", "--videos", "1", "--frames", "4", "--size", "32",
            "--sprites", "2"]
    assert t_cli.main(args + ["--output-dir", str(tmp_path / "t")]) == 0
    assert j_cli.main(args + ["--output-dir", str(tmp_path / "j")]) == 0
    out = capsys.readouterr().out
    assert "wrote 1 clips x 4 frames (2 triplets)" in out
    assert "train with: fi-torch train" in out
    for name in sorted(os.listdir(tmp_path / "j" / "scene_000")):
        got = load_image(str(tmp_path / "t" / "scene_000" / name))
        want = cv2.imread(str(tmp_path / "j" / "scene_000" / name),
                          cv2.IMREAD_GRAYSCALE)[..., None]
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, name


@pytest.fixture(scope="module")
def pth_and_frames(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    sd = reference_state_dict(11)
    path = str(root / "best_model.pth")
    torch.save({"epoch": 4, "model_state_dict": {
        k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()},
        "train_loss": 0.125, "val_loss": 0.25}, path)
    gen = np.random.default_rng(12)
    frames = []
    for i in range(2):
        img = gen.integers(0, 256, (32, 32, 1), dtype=np.uint8)
        frames.append(str(root / f"f{i}.png"))
        save_image(frames[-1], img)
    return path, frames


@pytest.mark.parametrize("num", [1, 3])
def test_infer_matches_jax(pth_and_frames, tmp_path, num):
    path, (a, b) = pth_and_frames
    args = ["infer", "--frame1", a, "--frame2", b, "--model", path,
            "--channels", "1", "--base-width", str(BASE), "--dtype",
            "float32", "--num-intermediate", str(num)] + HW
    t_out, j_out = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    assert t_cli.main(args + CPU + ["--output", t_out]) == 0
    assert j_cli.main(args + ["--output", j_out]) == 0
    if num == 1:
        pairs = [(t_out, j_out)]
    else:
        pairs = [(str(tmp_path / f"t_intermediate_{i:02d}.png"),
                  str(tmp_path / f"j_intermediate_{i:02d}.png"))
                 for i in range(1, num + 1)]
        assert os.path.getsize(str(tmp_path / "t_video.mp4")) > 0
    for t, j in pairs:
        got = load_image(t)
        want = cv2.imread(j, cv2.IMREAD_GRAYSCALE)[..., None]
        assert got.shape == want.shape == (32, 32, 1)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_info_on_a_pth_prints_jax_lines(pth_and_frames, capsys):
    path, _ = pth_and_frames
    assert j_cli.main(["info", "--model", path]) == 0
    want = capsys.readouterr().out
    assert t_cli.main(["info", "--model", path]) == 0
    assert capsys.readouterr().out == want
    assert "  epoch: 4\n" in want and "  val_loss: 0.250000\n" in want


def test_convert_round_trip(pth_and_frames, tmp_path):
    path, (a, b) = pth_and_frames
    export, back = str(tmp_path / "export"), str(tmp_path / "back.pth")
    assert t_cli.main(["convert", "--input", path, "--output", export]) == 0
    assert t_cli.main(["convert", "--input", export, "--output", back]) == 0
    want = torch.load(path, weights_only=False)["model_state_dict"]
    got = torch.load(back, weights_only=False)["model_state_dict"]
    assert set(got) == {k for k in want
                        if not k.endswith("num_batches_tracked")}
    for k in got:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    # the export directory serves what the .pth serves
    outs = []
    for model in (path, export):
        out = str(tmp_path / f"{len(outs)}.png")
        assert t_cli.main(["infer", "--frame1", a, "--frame2", b, "--model",
                           model, "--dtype", "float32", "--output", out]
                          + HW + CPU) == 0
        outs.append(load_image(out))
    assert np.array_equal(*outs)
    with pytest.raises(SystemExit, match="must be a .pth file"):
        t_cli.main(["convert", "--input", export, "--output",
                    str(tmp_path / "x")])
    assert t_cli.main(["convert", "--input", str(tmp_path / "nothing"),
                       "--output", back]) == 1


def test_train_then_info(tmp_path, capsys):
    data = str(tmp_path / "data")
    write_fixture_tree(data, num_videos=1, num_frames=6, height=32, width=32)
    ckpt = str(tmp_path / "ckpt")
    assert t_cli.main(["train", "--data-dir", data, "--epochs", "1",
                       "--batch-size", "2", "--base-width", str(BASE),
                       "--checkpoint-dir", ckpt, "--num-workers", "1",
                       "--val-split", "0.25"] + HW + CPU) == 0
    out = capsys.readouterr().out
    assert "dataset: 4 triplets (3 train / 1 val)" in out
    assert "epoch 1/1" in out
    assert os.path.exists(os.path.join(ckpt, "variables.pt"))
    assert t_cli.main(["info", "--model", ckpt]) == 0
    out = capsys.readouterr().out
    assert "  epochs completed: 1\n" in out and "best val loss" in out
    assert "'base_width': 4" in out


def test_train_flow_options_then_infer_the_export(tmp_path, capsys):
    # the bidirectional field through a cascade stage on the pyramid warp,
    # one step (3 train triplets, batch 2), its export loaded by infer
    data = str(tmp_path / "data")
    write_fixture_tree(data, num_videos=1, num_frames=6, height=32, width=32)
    ckpt = str(tmp_path / "ckpt")
    assert t_cli.main(["train", "--data-dir", data, "--epochs", "1",
                       "--batch-size", "2", "--arch", "flow",
                       "--base-width", str(BASE), "--flow-bidir",
                       "--flow-cascade", "1", "--warp-impl", "pyramid",
                       "--max-flow", "8", "--flow-photo", "0.1",
                       "--checkpoint-dir", ckpt, "--num-workers", "1",
                       "--val-split", "0.25"] + HW + CPU) == 0
    assert "epoch 1/1" in capsys.readouterr().out
    assert t_cli.main(["info", "--model", ckpt]) == 0
    out = capsys.readouterr().out
    assert "'flow_bidir': True" in out and "'flow_cascade': 1" in out
    assert "'warp_impl': 'pyramid'" in out
    frame = os.path.join(data, "video_00", "frame_{:03d}.png")
    mid = str(tmp_path / "mid.png")
    assert t_cli.main(["infer", "--frame1", frame.format(0), "--frame2",
                       frame.format(2), "--model", ckpt, "--dtype",
                       "float32", "--output", mid] + HW + CPU) == 0
    img = load_image(mid)
    assert img.shape == (32, 32, 1) and img.dtype == np.uint8


def test_num_devices_above_one_raises_naming_data_parallel(
        tmp_path, monkeypatch, capsys):
    # data parallel runs one process per card: more cards than are
    # visible exit 1 with JAX make_mesh's error, before any process starts
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert t_cli.main(["train", "--data-dir", str(tmp_path), "--device",
                       "cuda", "--num-devices", "2"]) == 1
    assert "requested 2 devices, only 1 visible" in capsys.readouterr().err


def test_serve_core_impl_pallas_at_an_ineligible_shape_exits_1(
        pth_and_frames, capsys):
    path, _ = pth_and_frames
    assert t_cli.main(["serve", "--model", path, "--core-impl", "pallas",
                       "--port", "0", "--host", "127.0.0.1"] + HW + CPU) == 1
    assert "core_impl='pallas'" in capsys.readouterr().err


def test_eval_writes_every_artifact(pth_and_frames, tmp_path, capsys):
    path, _ = pth_and_frames
    data = str(tmp_path / "test")
    write_fixture_tree(data, num_videos=1, num_frames=5, height=32, width=32)
    out = str(tmp_path / "results")
    assert t_cli.main(["eval", "--test-dir", data, "--model", path,
                       "--output-dir", out, "--dtype", "float32"]
                      + HW + CPU) == 0
    assert "EVALUATION SUMMARY (3 triplets)" in capsys.readouterr().out
    for name in ("results.json", "summary.csv", "report.md",
                 "plots/psnr_comparison.png", "plots/ssim_comparison.png",
                 "plots/psnr_with_std.png", "plots/combined_comparison.png",
                 "plots/README.md", "comparisons/comparison_best.png",
                 "comparisons/comparison_median.png",
                 "comparisons/comparison_worst.png"):
        assert os.path.getsize(os.path.join(out, name)) > 0, name


def test_the_model_config_follows_jax(pth_and_frames):
    parser = t_cli.build_parser()
    args = parser.parse_args(["infer", "--frame1", "a", "--frame2", "b",
                              "--arch", "flow", "--flow-scale", "4",
                              "--refine-width", "16", "--max-flow", "16"])
    assert t_cli._model_config(args) == TConfig(
        arch="flow", flow_scale=4, refine_width=16, max_flow=16)
    args = parser.parse_args(["infer", "--frame1", "a", "--frame2", "b"])
    assert t_cli._model_config(args) is None
    args = parser.parse_args(["infer", "--frame1", "a", "--frame2", "b",
                              "--core-pack", "2", "--model",
                              pth_and_frames[0]] + CPU)
    assert t_cli._load_engine(args).core_pack == 2
