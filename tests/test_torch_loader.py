"""The port's training data vs the JAX package's: the triplet loader and
the procedural scenes (JAX's generator needs OpenCV, which the tests'
environment has; the port's runs without it)."""

import os

import cv2
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.data import synthetic as ts
from ai_based_frame_interpolation_torch.data.loader import (
    TripletLoader as TLoader)
from ai_based_frame_interpolation_torch.data.triplets import scan_triplets
from ai_based_frame_interpolation_torch.ops.image import load_image
from ai_based_frame_interpolation_tpu.data import synthetic as js
from ai_based_frame_interpolation_tpu.data.loader import (
    TripletLoader as JLoader)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("scenes"))
    ts.write_scene_tree(root, num_videos=3, num_frames=6, height=24,
                        width=32, seed=11)
    return root


LOADERS = {
    "shuffled_augmented_remainder": dict(batch_size=5, seed=3, augment=True,
                                         drop_remainder=False),
    "shuffled_drop_remainder": dict(batch_size=4, seed=1),
    "in_order_with_a_corrupt_file": dict(batch_size=3, shuffle=False,
                                         drop_remainder=False),
}


@pytest.mark.parametrize("name", list(LOADERS))
def test_triplet_loader_batches_equal_jax(tree, name, tmp_path):
    # the same uint8 batches in the same order for two epochs, bit for bit:
    # the shuffle, the augmentation, the remainder, and a file that fails
    # to decode (the previous good item repeats)
    triplets = scan_triplets(tree)
    if name == "in_order_with_a_corrupt_file":
        bad = tmp_path / "scene_bad"
        bad.mkdir()
        for i in range(4):
            src = os.path.join(triplets[i].video_dir, f"frame_{i:03d}.png")
            data = open(src, "rb").read()
            (bad / f"frame_{i:03d}.png").write_bytes(
                data[:40] if i == 1 else data)
        triplets = triplets[:4] + scan_triplets(str(tmp_path))
    kw = dict(LOADERS[name], height=24, width=32, num_workers=2)
    tl = TLoader(triplets, device="cpu", **kw)
    jl = JLoader(triplets, **kw)
    assert len(tl) == len(jl)
    for _ in range(2):
        got, want = list(tl), list(jl)
        assert len(got) == len(want) == len(tl)
        for g, w in zip(got, want):
            for k in ("f0", "f1", "gt"):
                assert g[k].dtype == torch.uint8
                np.testing.assert_array_equal(g[k].numpy(), w[k])


@pytest.mark.parametrize("motion", ["linear", "hard"])
@pytest.mark.parametrize("kw", [dict(height=64, width=48),
                                dict(height=40, width=56, channels=3,
                                     flicker=0.3, num_sprites=6)],
                         ids=["gray", "rgb_flicker"])
def test_moving_scene_frames_within_1lsb_of_jax(motion, kw):
    # OpenCV's cubic resize and affine warp ported to numpy: every pixel
    # within 1 LSB of the JAX generator's frames; the share of identical
    # pixels is printed (1 LSB where a value sits at an integer boundary)
    got = ts.moving_scene_frames(num_frames=6, seed=5, motion=motion, **kw)
    want = js.moving_scene_frames(num_frames=6, seed=5, motion=motion, **kw)
    assert got.shape == want.shape and got.dtype == np.uint8
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    print(f"{motion} {kw}: bit-identical share {float((d == 0).mean()):.6f}")
    assert int(d.max()) <= 1


@pytest.mark.parametrize("case", ["pan", "rotate_zoom", "outside"])
def test_opencv_ports_match_cv2(case):
    # the warp bit for bit with the installed OpenCV (its float-coordinate
    # kernels); the cubic resize within 1e-4 at the scene's intensities
    rng = np.random.default_rng(2)
    grid = rng.uniform(30, 170, (9, 11, 3)).astype(np.float32)
    canvas = cv2.resize(grid, (150, 130), interpolation=cv2.INTER_CUBIC)
    np.testing.assert_allclose(ts.resize_cubic(grid, 130, 150), canvas,
                               rtol=0, atol=1e-4)
    m = {"pan": [[1, 0, -20.3], [0, 1, -11.7]],
         "rotate_zoom": cv2.getRotationMatrix2D((60.5, 50.2), 9.7, 1.03),
         "outside": [[1.1, 0.2, 30.0], [-0.1, 0.9, -70.5]]}[case]
    m = np.float32(m)
    if case == "rotate_zoom":
        np.testing.assert_allclose(
            ts.rotation_matrix((60.5, 50.2), 9.7, 1.03),
            cv2.getRotationMatrix2D((60.5, 50.2), 9.7, 1.03), rtol=0,
            atol=1e-9)
    np.testing.assert_array_equal(
        ts.warp_affine_linear(canvas, m, 96, 80),
        cv2.warpAffine(canvas, m, (96, 80), flags=cv2.INTER_LINEAR))


def test_write_scene_tree_round_trips(tree):
    # the PNGs hold the generator's frames, and OpenCV reads the same
    dirs = sorted(os.listdir(tree))
    assert dirs == ["scene_000", "scene_001", "scene_002"]
    want = ts.moving_scene_frames(6, 24, 32, seed=11 + 1000)
    for i in range(6):
        path = os.path.join(tree, "scene_001", f"frame_{i:03d}.png")
        np.testing.assert_array_equal(load_image(path), want[i])
        np.testing.assert_array_equal(
            cv2.imread(path, cv2.IMREAD_GRAYSCALE)[..., None], want[i])
