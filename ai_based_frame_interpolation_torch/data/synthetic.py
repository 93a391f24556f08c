"""Deterministic synthetic fixtures (JAX ``data/synthetic.py``), written
through the port's PNG encoder.

- :func:`moving_circle_frames`: a white disc translating left to right
  with additive noise, as the reference's ``demo_simple.py:17-40`` draws
  it;
- :func:`moving_scene_frames`: the procedural training scenes (a panned,
  in the "hard" tier also rotated and zoomed, textured background, moving
  sprites, a brightness ramp, flicker and noise), the same numpy code as
  JAX's with its two OpenCV calls ported as numpy functions that follow
  OpenCV's rules (:func:`resize_cubic`, :func:`warp_affine_linear`): the
  port requires no OpenCV. The frames agree with JAX's within 1 LSB
  (``tests/test_torch_loader.py``).

Trees go to disk in the reference's layout ``<root>/<video>/frame_XXX.png``
(:func:`write_fixture_tree`, :func:`write_scene_tree`);
:func:`write_fixture_video` writes the disc as a small MP4 through
``data/video.py`` (OpenCV).
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from ..ops.image import save_image


def moving_circle_frames(num_frames: int = 5, height: int = 256,
                         width: int = 256, radius: int = 30,
                         step: int = 40, noise: int = 10,
                         channels: int = 1, seed: int = 0) -> np.ndarray:
    """[T, H, W, C] uint8 frames of a bright disc translating left->right."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:height, 0:width]
    frames = []
    for t in range(num_frames):
        cx = radius + 20 + t * step
        cy = height // 2
        disc = ((xx - cx) ** 2 + (yy - cy) ** 2) <= radius ** 2
        img = np.full((height, width), 40, np.float32)
        img[disc] = 230.0
        img = img + rng.uniform(-noise, noise, img.shape)
        frame = np.clip(img, 0, 255).astype(np.uint8)[..., None]
        if channels == 3:
            frame = np.repeat(frame, 3, axis=-1)
        frames.append(frame)
    return np.stack(frames)


def write_fixture_tree(root: str, num_videos: int = 1, num_frames: int = 5,
                       height: int = 256, width: int = 256,
                       channels: int = 1, seed: int = 0) -> List[str]:
    """Write ``<root>/video_XX/frame_XXX.png`` trees; returns video dirs."""
    dirs = []
    for v in range(num_videos):
        vdir = os.path.join(root, f"video_{v:02d}")
        os.makedirs(vdir, exist_ok=True)
        frames = moving_circle_frames(num_frames, height, width,
                                      channels=channels, seed=seed + v,
                                      step=max(8, 40 - 6 * v))
        for i, f in enumerate(frames):
            save_image(os.path.join(vdir, f"frame_{i:03d}.png"), f)
        dirs.append(vdir)
    return dirs


def _cubic_taps(n_src: int, n_dst: int):
    """``cv2.resize(INTER_CUBIC)``'s taps along one axis: source indices
    [n_dst, 4] (edge-replicated) and the weights [n_dst, 4] of the cubic
    kernel with a = -0.75 at the half-pixel source coordinate."""
    f = (np.arange(n_dst) + 0.5) * (n_src / n_dst) - 0.5
    s = np.floor(f)
    x = f - s
    a = -0.75
    c0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
    c1 = ((a + 2) * x - (a + 3)) * x * x + 1
    c2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
    idx = np.clip(s.astype(np.int64)[:, None] + np.arange(-1, 3), 0, n_src - 1)
    return idx, np.stack([c0, c1, c2, 1 - c0 - c1 - c2], 1)


def resize_cubic(src: np.ndarray, height: int, width: int) -> np.ndarray:
    """HWC ``src`` resized to (height, width) as ``cv2.resize(...,
    interpolation=cv2.INTER_CUBIC)`` resizes it: along the rows, then the
    columns, each a 4-tap sum, the border replicated; f64 inside, f32 out
    (within 1e-4 of OpenCV's f32 sums at the scene's intensities)."""
    src = np.asarray(src, np.float64)
    ix, wx = _cubic_taps(src.shape[1], width)
    iy, wy = _cubic_taps(src.shape[0], height)
    rows = sum(src[:, ix[:, k]] * wx[:, k, None] for k in range(4))
    return sum(rows[iy[:, k]] * wy[:, k, None, None]
               for k in range(4)).astype(np.float32)


def rotation_matrix(center, angle: float, scale: float) -> np.ndarray:
    """``cv2.getRotationMatrix2D(center, angle, scale)``: [2, 3] f64, the
    center taken as f32 (OpenCV's ``Point2f``)."""
    a = angle * (np.pi / 180)
    alpha, beta = np.cos(a) * scale, np.sin(a) * scale
    cx, cy = (float(np.float32(v)) for v in center)
    return np.array([[alpha, beta, (1 - alpha) * cx - beta * cy],
                     [-beta, alpha, beta * cx + (1 - alpha) * cy]])


def _fma(a, b, c) -> np.ndarray:
    """f32 ``a * b + c`` rounded once (the product of two f32 is exact in
    f64)."""
    return (np.asarray(a, np.float64) * b + c).astype(np.float32)


def warp_affine_linear(src: np.ndarray, m: np.ndarray, width: int,
                       height: int) -> np.ndarray:
    """f32 HWC ``src`` warped by the [2, 3] affine ``m`` into (height,
    width) as ``cv2.warpAffine(src, m, (width, height),
    flags=cv2.INTER_LINEAR)`` warps it with OpenCV's float-coordinate
    kernels (OpenCV 4.11 and later; the older fixed-point map rounded
    source positions to 1/32 pixel): ``m`` inverted in f64 and rounded to
    f32, each output pixel's source position ``fma(m0, x, m1 y + m2)`` in
    f32, and the four taps blended by two f32 lerps ``fma(t, b - a, a)``
    along x, then one along y, zeros outside the source
    (``BORDER_CONSTANT``)."""
    src = np.asarray(src, np.float32)
    h, w = src.shape[:2]
    m = np.asarray(m, np.float64).reshape(6)
    d = m[0] * m[4] - m[1] * m[3]
    d = 1.0 / d if d != 0 else 0.0
    i0, i1, i3, i4 = m[4] * d, -m[1] * d, -m[3] * d, m[0] * d
    inv = np.float32([i0, i1, -i0 * m[2] - i1 * m[5],
                      i3, i4, -i3 * m[2] - i4 * m[5]])
    xs = np.arange(width, dtype=np.float32)[None]
    ys = np.arange(height, dtype=np.float32)[:, None]
    sx = _fma(inv[0], xs, inv[1] * ys + inv[2])
    sy = _fma(inv[3], xs, inv[4] * ys + inv[5])
    x0, y0 = np.floor(sx), np.floor(sy)
    tx, ty = (sx - x0)[..., None], (sy - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)

    def tap(yy, xx):
        inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        return np.where(inside[..., None],
                        src[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                        np.float32(0))

    v00, v01 = tap(y0, x0), tap(y0, x0 + 1)
    v10, v11 = tap(y0 + 1, x0), tap(y0 + 1, x0 + 1)
    top = _fma(tx, v01 - v00, v00)
    bot = _fma(tx, v11 - v10, v10)
    return _fma(ty, bot - top, top)


def moving_scene_frames(num_frames: int = 16, height: int = 256,
                        width: int = 256, channels: int = 1,
                        num_sprites: int = 4, max_speed: float = 6.0,
                        noise: float = 4.0, seed: int = 0,
                        motion: str = "linear",
                        flicker: float = 0.0) -> np.ndarray:
    """[T, H, W, C] uint8 frames of a procedural scene, the JAX
    generator's (its docstring has the design): a band-limited background
    panned at a global velocity (``motion="hard"``: also rotated and
    zoomed), ``num_sprites`` anti-aliased sprites (discs, blobs, rounded
    rectangles) with their own velocities and sizes (``"hard"``: also
    accelerations and orbits), a brightness ramp, ``flicker`` (a per-frame
    exposure modulation) and sensor noise. Every frame is rendered at its
    own time, so frame t+1 is the true midpoint of frames t and t+2."""
    if motion not in ("linear", "hard"):
        raise ValueError(f"motion must be 'linear' or 'hard', got {motion!r}")
    rng = np.random.default_rng(seed)
    c = 3 if channels == 3 else 1

    pan_v = rng.uniform(-max_speed / 2, max_speed / 2, size=2)
    rot_v = rng.uniform(-1.5, 1.5) if motion == "hard" else 0.0   # deg/frame
    zoom_v = rng.uniform(-4e-3, 4e-3) if motion == "hard" else 0.0
    pad = int(np.ceil(max_speed / 2 * (num_frames + 1))) + 4
    if motion == "hard":
        diag = 0.5 * float(np.hypot(height, width))
        ang = abs(rot_v) * (num_frames - 1) * np.pi / 180.0
        pad += int(np.ceil(diag * (ang + abs(zoom_v) * (num_frames - 1)))) + 4
    ch_, cw_ = height + 2 * pad, width + 2 * pad
    grid = rng.uniform(30, 170, size=(ch_ // 32 + 2, cw_ // 32 + 2, c))
    canvas = resize_cubic(grid.astype(np.float32), ch_, cw_)

    sprites = []
    for _ in range(num_sprites):
        s = {
            "kind": rng.choice(["disc", "blob", "rect"]),
            "p0": rng.uniform([0, 0], [height, width]),
            "v": rng.uniform(-max_speed, max_speed, size=2),
            "r0": rng.uniform(5.0, max(6.0, min(height, width) / 5)),
            "rv": rng.uniform(-0.5, 0.5),
            "color": rng.uniform(60, 255, size=c),
            "a": np.zeros(2), "orbit_r": 0.0, "orbit_w": 0.0,
            "orbit_phi": 0.0,
        }
        if motion == "hard":
            s["a"] = rng.uniform(-max_speed / 8, max_speed / 8, size=2)
            if rng.uniform() < 0.5:
                s["orbit_r"] = rng.uniform(4.0, min(height, width) / 6)
                s["orbit_w"] = rng.uniform(-0.5, 0.5)       # rad/frame
                s["orbit_phi"] = rng.uniform(0, 2 * np.pi)
        sprites.append(s)
    ramp = rng.uniform(-0.3, 0.3)
    flick_period = rng.uniform(2.5, 5.0)
    flick_phase = rng.uniform(0, 2 * np.pi)

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    frames = []
    for t in range(num_frames):
        oy, ox = pad + pan_v[0] * t, pad + pan_v[1] * t
        if motion == "hard":
            mr = rotation_matrix((float(ox + width / 2),
                                  float(oy + height / 2)),
                                 rot_v * t, 1.0 + zoom_v * t)
            mr[0, 2] -= ox
            mr[1, 2] -= oy
            m = np.float32(mr)
        else:
            m = np.float32([[1, 0, -ox], [0, 1, -oy]])
        img = warp_affine_linear(canvas, m, width, height)

        for s in sprites:
            cy, cx = (s["p0"] + s["v"] * t + 0.5 * s["a"] * t * t)
            if s["orbit_r"]:
                phi = s["orbit_phi"] + s["orbit_w"] * t
                cy, cx = (cy + s["orbit_r"] * np.sin(phi),
                          cx + s["orbit_r"] * np.cos(phi))
            r = max(3.0, s["r0"] + s["rv"] * t)
            d = np.sqrt((yy - cy) ** 2 + (xx - cx) ** 2)
            if s["kind"] == "disc":
                alpha = np.clip(r - d, 0.0, 1.0)
            elif s["kind"] == "blob":
                alpha = np.exp(-0.5 * (d / (r / 2)) ** 2)
            else:
                dd = np.maximum(np.abs(yy - cy), np.abs(xx - cx))
                alpha = np.clip(r - dd, 0.0, 1.0)
            img = img * (1 - alpha[..., None]) + s["color"] * alpha[..., None]

        gain = 1.0 + ramp * (t / max(1, num_frames - 1))
        if flicker:
            gain *= 1.0 + flicker * np.sin(
                2 * np.pi * t / flick_period + flick_phase)
        img = img * gain + rng.uniform(-noise, noise, img.shape)
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(frames)


def write_scene_tree(root: str, num_videos: int = 8, num_frames: int = 16,
                     height: int = 256, width: int = 256,
                     channels: int = 1, seed: int = 0,
                     num_sprites: int = 4,
                     motion: str = "linear",
                     max_speed: float = 6.0,
                     flicker: float = 0.0) -> List[str]:
    """Write a training tree of :func:`moving_scene_frames` clips,
    ``<root>/scene_XXX/frame_XXX.png``, clip v from seed ``seed + 1000 v``
    (as JAX's); returns the clip dirs."""
    dirs = []
    for v in range(num_videos):
        vdir = os.path.join(root, f"scene_{v:03d}")
        os.makedirs(vdir, exist_ok=True)
        frames = moving_scene_frames(num_frames, height, width,
                                     channels=channels, seed=seed + 1000 * v,
                                     num_sprites=num_sprites, motion=motion,
                                     max_speed=max_speed, flicker=flicker)
        for i, f in enumerate(frames):
            save_image(os.path.join(vdir, f"frame_{i:03d}.png"), f)
        dirs.append(vdir)
    return dirs


def write_fixture_video(path: str, num_frames: int = 30, height: int = 128,
                        width: int = 128, fps: float = 30.0,
                        seed: int = 0) -> str:
    """Write a small MP4 of the moving circle (for video-pipeline tests)."""
    from .video import VideoWriter

    frames = moving_circle_frames(num_frames, height, width, channels=3,
                                  step=max(1, width // (num_frames + 2)),
                                  seed=seed)
    with VideoWriter(path, fps=fps) as w:
        for f in frames:
            w.write(f)
    return path
