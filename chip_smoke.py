"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port only (it imports nothing of JAX or of the JAX package):

1. prints the card (``nvidia-smi`` name and power limit), builds every CUDA
   source of the package for sm_90a (one ``nvcc`` each, all at once) and
   prints the build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes and a few more: the refinement head at width 64 (the
   U-Net head) and 16 (the flow head, 5 or 15 planes), the depthwise head
   (1088x1920 gray, small RGB), each instance also where its tile loop can
   break (tiles on a batch boundary, widths that are not a multiple of 8
   in gray and RGB, an image smaller than a tile, planes at a data pointer
   that is not 16-byte aligned; the flow head with 15 planes at 2x37x53;
   the U-Net head with 15 planes, which takes one group of warps), with
   the variant each launch took (groups, shared memory, blocks per SM),
   the flow sampler (the flow path's shapes and the edges of its tiles:
   images off the tile and smaller than the flow's reach, saturated
   flows, unaligned pointers, both layouts, RGB and f32, each bit for bit
   with the path it took), the SSIM kernel (the eval
   path's 8x256x256 and 8x1080x1920, 4K, RGB, 7x7, f32 inputs, identical
   images, its strip and band edges, two runs bit for bit), and the
   option core's double conv (inc,
   down1, down2 at b8 1080p) and up block (up3, up4), with heights and
   widths off the tile, a 7-row image, uneven channel counts and the
   align-corners composition; then every head route the port has besides
   those (bf16 heads at widths 8 and 32 padded to the fused instances,
   depthwise heads at widths 16 and 32, dense bf16 heads at widths 128 and
   256 on the tensor-core double conv and the out conv, a depthwise bf16
   head at width 128 and f32 heads at widths 64 and 16, dense and
   depthwise, on the direct convs) and the f32 double conv and up block
   (the direct convs) at the five levels' b2 1080p shapes, two b8 ones and
   odd ones, f32 against a plain side run with TF32 off, and the direct
   conv alone in each of its modes at odd channel counts; each check also
   reads the launches its wrapper counted under the route it took;
3. drives the U-Net path once: the full-width production U-Net engine
   (s2d 4, base 64, depth 4, residual, refinement head 64, half-pixel
   decoder, random weights from a seed) on a batch of 8 gray 1080p frame
   pairs, with every kernel's launch count set to 0 just before and read
   just after, and checks the output against the same port modules composed
   with the plain head; then answers concurrent requests through the port's
   batcher; then the same two ways with the option core
   (``core_impl="pallas"``: 3 double-conv, 2 up-block and 1 head launch per
   dispatch, also within 1 LSB of the default route on the same weights),
   the option core again with the align-corners decoder (5 double-conv
   launches, the upsample composed) against its own default route, and
   with the depthwise head (``refine_depthwise=True``), then the f32
   production engine (``compute_dtype=torch.float32``) at b2 1080p on the
   default route (the head on the direct convs: 2 + 1 launches) and on the
   option core (10 more direct-conv launches), TF32 off for the phase;
4. drives the flow path the same way: the full-width flow production engine
   (base 32, depth 4, flow_scale 4, refinement head 16, shifts warp,
   max_flow 16) on 8 gray 1080p pairs, checked against the same modules
   composed with the plain sampler and head, then 3 in-betweens, two
   arbitrary times and concurrent requests through the batcher;
5. times the engines (U-Net on the default route, the option core and the
   depthwise head; flow) and each kernel and route with CUDA events (the
   sampler at b1 and b8 and the SSIM kernel also by their own device
   time, torch.profiler; the
   option core's levels with the time per weight chunk; the f32 levels at
   the f32 engine's b2 and at b8 for down1 and up3), the host PNG
   decode of a 1080p gray file per scanline filter, and the eval path's
   ``evaluate_model`` calls split into decode, engine and metric time,
   with the device's busy time in one profiled call;
6. drives the eval path (run before 5 frees the engines): PNG fixtures
   written by the port, ``evaluate_model`` with the U-Net engine at
   256x256 (16 triplets) and 1080x1920 (8 triplets, once with filter 0 as
   the port writes and once re-encoded with rows cycling through all five
   filters, as adaptive encoders mix them) and with the flow engine at
   256x256, counts set to 0 before each run and read after, every
   per-triplet PSNR and SSIM held against the plain metrics on the same
   arrays, and the JSON, CSV and markdown reports written and read back.

Besides each kernel's launch counter, the wrappers that pick a route
(``refine_head``, ``double_conv_fused``, ``up_double_conv_fused``) count
their launches under it (``.routes``); the kernels line reads those counts
over the main-path runs of phases 3, 4 and 6.

Any failure raises and exits non-zero. It prints the kernel record as one
JSON line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
after a ``record {...}`` line with every number it measured.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak, FLOP/s
H100_HBM_BYTES = 3.35e12       # HBM3 bandwidth, B/s
FLOAT_BOUND = 0.032            # 2 bf16 ulp at |x| < 4 (see check_kernel)
PROD = dict(space_to_depth=4, residual=True, refine_width=64,
            upsample="half_pixel")
FLOW_PROD = dict(arch="flow", base_width=32, flow_scale=4, refine_width=16,
                 warp_impl="shifts", max_flow=16)
H100_F32_FLOPS = 67e12         # f32 outside the tensor cores, FLOP/s
SAMPLER_BOUND = 1e-5           # f32 lerps rounded where the plain version rounds
# the repo's cross-route SSIM bound (tests/test_pallas_ssim.py): exact
# window sums in the kernel, 1/7 weights in two passes in the plain version
SSIM_BOUND = 2e-4
SSIM_FLOPS_PER_PX = 90         # per valid position: 3 mul, 60 adds, ~25 algebra, 1 sum
PSNR_BOUND_DB = 1e-4
F32_BOUND = 1e-4               # f32 kernels vs plain with TF32 off: sums in another order


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def no_tf32():
    """Full f32 convolutions and matmuls (cuDNN's f32 convs run in TF32 by
    default) for an f32 plain side, restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def bf16_ulp(want: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude of the largest value of ``want``."""
    mag = float(want.float().abs().max())
    return 2.0 ** (np.floor(np.log2(mag)) - 7) if mag > 0 else 2.0 ** -133


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean ms per call of ``fn`` on the current stream, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def head_inputs(b, h, w, c, nextra, width=64, seed=0, nf32=0,
                depthwise=False):
    """Random head inputs and weights (PyTorch layouts) on the card; the
    first ``nf32`` planes are f32 (the flow sampler's warped frames), the
    rest bf16; ``depthwise``: conv2 as a depthwise 3x3 and a 1x1."""
    gen = torch.Generator().manual_seed(seed)
    nplanes = (1 + nextra) * c

    def conv(cin, cout, k, groups=1):
        wt = torch.randn(cout, cin // groups, k, k, generator=gen) / (
            k * k * cin // groups) ** 0.5
        return {"weight": wt.cuda(), "bias": (0.1 * torch.randn(
            cout, generator=gen)).cuda()}

    params = {"refine1": conv(nplanes, width, 3),
              "refine_out": conv(width, c, 1)}
    if depthwise:
        params["refine2_dw"] = conv(width, width, 3, groups=width)
        params["refine2_pw"] = conv(width, width, 1)
    else:
        params["refine2"] = conv(width, width, 3)
    y = (torch.rand(b, h, w, c, generator=gen) * 2 - 1).cuda()
    planes = [(torch.rand(b, h, w, c, generator=gen) * 2 - 1).to(
        torch.float32 if k < nf32 else torch.bfloat16).cuda()
        for k in range(nextra)]
    return y, planes, params


def offset_view(t: torch.Tensor, k: int) -> torch.Tensor:
    """t's values as a contiguous view k elements into a larger buffer (a
    frame sliced from a stack): its data pointer is not 16-byte aligned
    for k = 1."""
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    view = buf[k:].view(t.shape)
    view.copy_(t)
    return view


def check_kernel(shape, width=64, nf32=0, depthwise=False,
                 offset=0) -> float:
    """The refine_head kernel vs its plain version on the card: within
    FLOAT_BOUND (both round each conv to bf16 around its bias; f32 sums in
    another order can flip a value on a rounding boundary by one ulp, which
    the next conv carries) and within 1 uint8 LSB after denormalize. With
    ``offset``, the prediction and every plane are views that many
    elements into larger buffers. Prints the variant the kernel took."""
    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        fused_variant, head_route, refine_head, refine_head_reference)

    b, h, w, c, nextra = shape
    y, planes, params = head_inputs(b, h, w, c, nextra, width, nf32=nf32,
                                    depthwise=depthwise)
    if offset:
        y = offset_view(y, offset)
        planes = [offset_view(p, offset) for p in planes]
        assert all(t.data_ptr() % 16 for t in [y] + planes)
    nplanes = (1 + nextra) * c
    variant = fused_variant(head_route(width, torch.bfloat16, depthwise),
                            nplanes, c, (1 << nf32) - 1)
    before = refine_head.launches
    got = refine_head(y, planes, params)
    torch.cuda.synchronize()
    assert refine_head.launches == before + 1, "refine_head did not launch"
    want = refine_head_reference(y, planes, params)
    err = float((got.float() - want.float()).abs().max())
    du = (denormalize_to_uint8(got).int() - denormalize_to_uint8(want).int()).abs()
    print(f"refine_head{' depthwise' if depthwise else ''} w{width} B={b} "
          f"{h}x{w} C={c} planes="
          f"{nplanes} ({nf32 * c} f32)"
          f"{f' at element offset {offset}' if offset else ''}: "
          f"max|kernel-plain|={err:.6g} uint8 differing={float((du > 0).float().mean()):.6g}"
          f" max uint8 diff={int(du.max())}; variant {variant['groups']} "
          f"group(s), {variant['smem']} B shared, "
          f"{variant['blocks_per_sm']} block(s)/SM", flush=True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert err <= FLOAT_BOUND, f"kernel disagrees by {err}"
    assert int(du.max()) <= 1, f"kernel disagrees by {int(du.max())} LSB"
    return err


def check_head_route(shape, width, dtype=torch.bfloat16, depthwise=False,
                     nf32=0) -> float:
    """The head on the kernel ``head_route`` picks (a fused instance, the
    width padded with zeros; the double conv and the out conv; or the
    direct convs) vs the plain head: bf16 within one ulp at the output's
    magnitude, f32 within F32_BOUND with TF32 off on the plain side; the
    route's launches counted (the dconv route's double-conv launch also
    under ``double_conv fused``)."""
    from ai_based_frame_interpolation_torch.ops.refine import (
        head_route, pack_head_weights, refine_head, refine_head_reference)

    b, h, w, c, nextra = shape
    y, planes, params = head_inputs(b, h, w, c, nextra, width, nf32=nf32,
                                    depthwise=depthwise)
    if dtype == torch.float32:
        planes = [p.float() for p in planes]
    route = head_route(width, dtype, depthwise)
    packed = pack_head_weights(params, dtype)
    before, routes = counts(), route_counts()
    got = refine_head(y, planes, params, dtype, packed)
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in counts().items()}
    expect = dict(NO_LAUNCHES, **{
        "direct": dict(conv_direct=3 if depthwise else 2, head_out_direct=1),
        "dconv": dict(double_conv=1, head_out_direct=1)}.get(
            route, dict(refine_head=1)))
    assert n == expect, f"head w{width} {dtype}: launches {n} != {expect}"
    key = (f"refine_head {route}/{'dw' if depthwise else 'w'}{width}/"
           f"{str(dtype)[6:]}")
    got_routes = {k: v - routes.get(k, 0) for k, v in route_counts().items()
                  if v != routes.get(k, 0)}
    want_routes = {key: sum(n.values())}
    if route == "dconv":
        want_routes["double_conv fused"] = 1
    assert got_routes == want_routes, \
        f"head w{width} {dtype}: routes {got_routes}"
    with no_tf32():
        want = refine_head_reference(y, planes, params, dtype)
    err = float((got.float() - want.float()).abs().max())
    tol = F32_BOUND if dtype == torch.float32 else bf16_ulp(want)
    print(f"refine_head route {route} {'depthwise ' if depthwise else ''}"
          f"w{width} {dtype} B={b} {h}x{w} planes={(1 + nextra) * c}: "
          f"max|kernel-plain|={err:.6g} (bound {tol:.6g}), bit-identical "
          f"{float((got == want).float().mean()):.6g}", flush=True)
    assert got.shape == want.shape and got.dtype == dtype
    assert bool(torch.isfinite(got.float()).all())
    assert err <= tol, f"head w{width} {dtype} disagrees by {err}"
    return err


def check_head_routes(record) -> None:
    """Phase 2's part for the heads beside the production instances: the
    padded bf16 widths, the depthwise head at 16 and 32, the wide bf16
    heads (dense 128 and 256 on the double conv, depthwise 128 on the
    direct convs) and the f32 heads (the U-Net's 3 planes; the flow head's
    5, 2 of them f32 warped frames), at one 1088x1920 frame and off the
    tile."""
    errs = {}
    for width, dt, dw, nextra, nf32 in (
            (8, torch.bfloat16, False, 2, 0), (32, torch.bfloat16, False, 2, 0),
            (16, torch.bfloat16, True, 2, 0), (32, torch.bfloat16, True, 2, 0),
            (128, torch.bfloat16, False, 2, 0),
            (256, torch.bfloat16, False, 2, 0),
            (128, torch.bfloat16, True, 2, 0),
            (64, torch.float32, False, 2, 0), (64, torch.float32, True, 2, 0),
            (16, torch.float32, False, 4, 2)):
        for shape in ((1, 1088, 1920, 1, nextra), (2, 40, 72, 1, nextra)):
            key = (f"{'dw' if dw else 'w'}{width}_{str(dt)[6:]}_"
                   f"{'x'.join(map(str, shape[:3]))}")
            errs[key] = check_head_route(shape, width, dt, dw, nf32)
    record["head_route_errs"] = errs


def check_direct_modes(record) -> None:
    """Phase 2's part for the direct conv's modes beyond the routes' own
    shapes, each launch vs ``conv_direct_reference`` on the same inputs
    (f32 within F32_BOUND, TF32 off on the plain side; bf16 within one ulp
    at the output's magnitude), one launch counted each: the tiles for 16,
    32 and 64 output channels, channel counts that are not multiples of 4
    (the plain-load staging and stores), an up block whose skip and up
    channels share a quad, depthwise over two channel blocks, and 1x1."""
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        conv_direct, conv_direct_reference, pack_conv)

    gen = torch.Generator().manual_seed(13)

    def rand(*shape):
        return torch.rand(*shape, generator=gen) * 2 - 1

    errs = {}
    # (B, H, W, c0, c1, cout, ks, depthwise)
    for b, h, w, c0, c1, cout, ks, dw in (
            (2, 19, 37, 5, 0, 6, 3, False), (2, 19, 37, 24, 0, 20, 3, False),
            (1, 33, 35, 24, 0, 72, 3, False), (2, 18, 34, 12, 6, 30, 3, False),
            (2, 18, 34, 16, 16, 64, 3, False), (1, 21, 40, 72, 0, 72, 3, True),
            (2, 19, 37, 20, 0, 20, 3, True), (2, 19, 37, 20, 0, 36, 1, False),
            (1, 40, 72, 40, 0, 12, 1, False)):
        cin = c0 + c1
        wt = rand(cout, 1 if dw else cin, ks, ks) / (ks * (1 if dw else cin)) ** 0.5
        x, low = rand(b, h, w, c0), (rand(b, h // 2, w // 2, c1) if c1 else None)
        for dt in (torch.float32, torch.bfloat16):
            p = pack_conv(wt, 0.1 * rand(cout), dt, depthwise=dw)
            args = (x.to(dt).cuda(), p["w"].cuda(), p["b"].cuda(),
                    None if low is None else low.to(dt).cuda())
            kw = {"depthwise": True, "relu": False} if dw else {}
            before = conv_direct.launches
            got = conv_direct(*args, **kw)
            torch.cuda.synchronize()
            assert conv_direct.launches == before + 1
            with no_tf32():
                want = conv_direct_reference(*args, **kw)
            err = float((got.float() - want.float()).abs().max())
            tol = F32_BOUND if dt == torch.float32 else bf16_ulp(want)
            key = (f"{'dw' if dw else f'{ks}x{ks}'}_{b}x{h}x{w}_{c0}+{c1}-"
                   f"{cout}_{str(dt)[6:]}")
            print(f"conv_direct {key}: max|kernel-plain|={err:.6g} (bound "
                  f"{tol:.6g})", flush=True)
            assert got.shape == want.shape and got.dtype == dt
            assert bool(torch.isfinite(got.float()).all())
            assert err <= tol, f"conv_direct {key} disagrees by {err}"
            errs[key] = err
    record["conv_direct_mode_errs"] = errs


def sampler_inputs(b, h, w, c, max_flow, ts, dtype=torch.bfloat16, seed=0,
                   layout="engine", offset=0, saturate=False):
    """Random sampler inputs on the card: frames in ``dtype``, flows out to
    1.5x the bound (so the clamp acts; ``saturate``: every flow 4x the
    bound, in a random direction per pixel and axis), per-item times
    ``ts``. ``layout="engine"``: frames, flow and mask as the NHWC views of
    NCHW tensors the flow model passes; ``"nhwc"``: all contiguous NHWC.
    ``offset``: every tensor starts that many elements into a larger
    buffer (a pointer that is not 16-byte aligned for 1)."""
    gen = torch.Generator().manual_seed(seed)
    f1, f2 = ((torch.rand(b, c, h, w, generator=gen) * 2 - 1).to(dtype)
              for _ in range(2))
    if saturate:
        flow = torch.where(torch.rand(b, 2, h, w, generator=gen) < 0.5,
                           -4.0, 4.0) * max_flow
    else:
        flow = (torch.rand(b, 2, h, w, generator=gen) * 2 - 1) * 1.5 * max_flow
    mask = torch.rand(b, 1, h, w, generator=gen)

    def put(x):
        if layout == "nhwc":
            return offset_view(x.permute(0, 2, 3, 1).cuda(), offset)
        return offset_view(x.cuda(), offset).permute(0, 2, 3, 1)

    t = torch.tensor(ts, dtype=torch.float32).cuda()
    return put(f1), put(f2), put(flow), put(mask), t


SAMPLER_TS8 = [0.5, 0.25, 0.8, 0.1, 0.9, 0.33, 0.6, 0.75]


def check_sampler(b, h, w, c, max_flow, ts, dtype=torch.bfloat16,
                  **layout) -> float:
    """The sample_fused kernel vs its plain version on the card: out, g0
    and g1 within SAMPLER_BOUND; prints whether all three are
    bit-identical, and the path the kernel reports, which must be the tiled
    one for gray frames in the flow model's layout and the general one for
    RGB and a contiguous NHWC flow (column stride 2)."""
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        kernel_path, sample_fused, sample_fused_reference)

    args = sampler_inputs(b, h, w, c, max_flow, ts, dtype, **layout)
    path = kernel_path(*args[:4])
    expect = "general" if c == 3 or layout.get("layout") == "nhwc" else "tiled"
    assert path == expect, f"sample_fused took the {path} path, not {expect}"
    before = sample_fused.launches
    got = sample_fused(*args, max_flow=max_flow)
    torch.cuda.synchronize()
    assert sample_fused.launches == before + 1, "sample_fused did not launch"
    want = sample_fused_reference(*args, max_flow=max_flow)
    errs = [float((g - r).abs().max()) for g, r in zip(got, want)]
    exact = all(torch.equal(g, r) for g, r in zip(got, want))
    print(f"sample_fused B={b} {h}x{w} C={c} mf{max_flow} {dtype} t={ts} "
          f"{layout or ''} ({path}): max|kernel-plain| out/g0/g1 = "
          f"{' / '.join(f'{e:.3g}' for e in errs)}"
          f"{', bit-identical' if exact else ''}", flush=True)
    for g in got:
        assert g.shape == (b, h, w, c) and g.dtype == torch.float32
        assert g.is_contiguous() and bool(torch.isfinite(g).all())
    assert max(errs) <= SAMPLER_BOUND, f"sampler disagrees by {max(errs)}"
    return max(errs)


def check_samplers(record) -> None:
    """Phase 2's sampler part: the flow path's 8x1088x1920 at mf16 with a
    time per item, a 1080p frame at mf32, and the tiled path's edges: tiles
    that end mid-image (100x200, 129x257), images narrower or shorter than
    the reach (24x24, 37x53, H = 2, W = 8 and 2, 9x7), flows that saturate
    the clamp in every direction (t = 0 and 1 too), B=8 off the tile,
    pointers off 16-byte alignment, rows that are not 16-byte multiples,
    f32 frames, a reach of 64; and the general path's: contiguous NHWC (a
    flow at column stride 2) and RGB."""
    errs = [check_sampler(8, 1088, 1920, 1, 16, SAMPLER_TS8),
            check_sampler(1, 1088, 1920, 1, 32, [0.5]),
            check_sampler(3, 100, 200, 1, 16, [0.2, 0.5, 0.9]),
            check_sampler(2, 24, 24, 1, 16, [0.4, 0.6]),
            check_sampler(2, 2, 64, 1, 16, [0.3, 0.8]),
            check_sampler(1, 40, 8, 1, 4, [0.5]),
            check_sampler(2, 129, 257, 1, 16, [0.33, 0.7]),
            check_sampler(2, 37, 53, 1, 16, [0.4, 0.6]),
            check_sampler(2, 2, 70, 1, 16, [0.3, 0.8]),
            check_sampler(1, 40, 2, 1, 4, [0.5]),
            check_sampler(2, 9, 7, 1, 4, [0.4, 0.6]),
            check_sampler(2, 72, 160, 1, 8, [0.0, 1.0], saturate=True),
            check_sampler(1, 96, 200, 1, 16, [0.5], saturate=True),
            check_sampler(8, 64, 128, 1, 16, SAMPLER_TS8),
            check_sampler(2, 72, 160, 1, 16, [0.5, 0.3], layout="nhwc"),
            check_sampler(2, 37, 53, 1, 16, [0.4, 0.6], offset=1),
            check_sampler(2, 72, 160, 1, 16, [0.5, 0.3], offset=1),
            check_sampler(2, 72, 160, 1, 8, [0.4, 0.6], torch.float32,
                          offset=1),
            check_sampler(2, 72, 160, 3, 16, [0.5, 0.3]),
            check_sampler(2, 72, 160, 3, 16, [0.5, 0.3], layout="nhwc"),
            check_sampler(2, 72, 160, 1, 8, [0.4, 0.6], torch.float32),
            check_sampler(1, 72, 160, 1, 64, [0.5])]
    record["sample_fused_max_abs_err"] = max(errs)


def ssim_inputs(b, h, w, c, seed=0, dtype=torch.uint8):
    """A structured image batch and a noisy copy on the card (uint8, or f32
    in [0, 1])."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    y = torch.arange(h, device="cuda", dtype=torch.float32).view(1, h, 1, 1)
    x = torch.arange(w, device="cuda", dtype=torch.float32).view(1, 1, w, 1)
    base = 127 + 90 * torch.sin(x / 23.0) * torch.cos(y / 17.0)
    a = base + 12 * torch.randn((b, h, w, c), generator=gen, device="cuda")
    bb = a + 10 * torch.randn((b, h, w, c), generator=gen, device="cuda")
    a, bb = (torch.round(t).clamp(0, 255) for t in (a, bb))
    if dtype == torch.uint8:
        return a.to(torch.uint8), bb.to(torch.uint8)
    return a / 255.0, bb / 255.0


def check_ssim(b, h, w, c, dtype=torch.uint8, same=False) -> float:
    """The ssim_eval kernel vs the plain ssim_eval on the card, within
    SSIM_BOUND (identical images: 1.0 within 1e-6)."""
    from ai_based_frame_interpolation_torch.ops.ssim import ssim_eval
    from ai_based_frame_interpolation_torch.ops.ssim_fused import (
        ssim_eval_auto, ssim_eval_fused)

    x, y = ssim_inputs(b, h, w, c, seed=h + w + c, dtype=dtype)
    if same:
        y = x.clone()
    dr = 255.0 if dtype == torch.uint8 else 1.0
    before = ssim_eval_fused.launches
    got = ssim_eval_auto(x, y, data_range=dr)
    torch.cuda.synchronize()
    assert ssim_eval_fused.launches == before + 1, "ssim_eval did not launch"
    want = ssim_eval(x, y, data_range=dr)
    err = float((got - want).abs().max())
    print(f"ssim_eval B={b} {h}x{w} C={c} {dtype}{' identical' if same else ''}"
          f": kernel {got[:4].tolist()} max|kernel-plain|={err:.3g}",
          flush=True)
    assert got.shape == (b,) and got.dtype == torch.float32
    assert bool(torch.isfinite(got).all())
    assert err <= SSIM_BOUND, f"ssim_eval disagrees by {err}"
    if same:
        assert float((got - 1.0).abs().max()) <= 1e-6, got
    return err


def check_ssim_kernels(record) -> None:
    """Phase 2's SSIM part: the eval path's shapes (unpadded), 720p and 4K,
    RGB, the smallest shape JAX tiles (70x16), one window (7x7), f32
    inputs, identical images, the kernel's strip and band edges (uint8
    strips of 256 valid columns and f32 strips of 64, at one strip, one
    column more and one less; bands of 2 rows at one image and one
    channel, 63, 64 and 65 valid rows: a last band of 1 row for the odd
    counts), two runs on the 1080p batch bit for bit, and two of its
    images alone (other bands) bit for bit with the batch. The kernel's
    partials per image plane must be the ones ops/ssim_fused.py mirrors."""
    from ai_based_frame_interpolation_torch.ops.ssim_fused import (
        _lib, partials_per_plane, ssim_eval_auto)

    for h, w in ((256, 256), (1080, 1920), (71, 263), (7, 7), (6, 40)):
        assert _lib().ssim_eval_tiles(h, w) == partials_per_plane(h, w), \
            f"ops/ssim_fused.py mirrors other partials at {h}x{w}"

    errs = {"8x256x256": check_ssim(8, 256, 256, 1),
            "8x1080x1920": check_ssim(8, 1080, 1920, 1),
            "1x2160x3840": check_ssim(1, 2160, 3840, 1),
            "2x720x1280": check_ssim(2, 720, 1280, 1),
            "2x129x257x3": check_ssim(2, 129, 257, 3),
            "2x70x16": check_ssim(2, 70, 16, 1),
            "1x7x7": check_ssim(1, 7, 7, 1),
            "2x64x96_f32": check_ssim(2, 64, 96, 1, torch.float32),
            "identical_2x256x256": check_ssim(2, 256, 256, 1, same=True),
            "1x70x262": check_ssim(1, 70, 262, 1),
            "1x71x263": check_ssim(1, 71, 263, 1),
            "1x69x261": check_ssim(1, 69, 261, 1),
            "2x135x519": check_ssim(2, 135, 519, 1),
            "1x70x70_f32": check_ssim(1, 70, 70, 1, torch.float32),
            "1x71x71_f32": check_ssim(1, 71, 71, 1, torch.float32),
            "1x69x69_f32": check_ssim(1, 69, 69, 1, torch.float32)}
    x, y = ssim_inputs(8, 1080, 1920, 1, seed=7)
    first, second = ssim_eval_auto(x, y), ssim_eval_auto(x, y)
    assert torch.equal(first, second), "ssim_eval is not deterministic"
    # alone, an image takes other bands (B sizes them): the same bits
    alone = torch.cat([ssim_eval_auto(x[i:i + 1], y[i:i + 1]) for i in (0, 7)])
    assert torch.equal(alone, first[[0, 7]]), "ssim_eval's bits depend on the batch"
    print(f"ssim_eval 8x1080x1920 twice: bit-identical {first.tolist()}",
          flush=True)
    record["ssim_eval_errs"] = errs
    record["ssim_eval_max_abs_err"] = max(errs.values())


def dconv_inputs(b, h, w, c0, c1, mid, cout, seed=0):
    """Random double-conv (c1 == 0) or up-block inputs and weights on the
    card: bf16 channels-last activations uniform in [-1, 1], conv weights
    scaled by 1/sqrt(fan_in) so the outputs stay of order 1, biases 0.1."""
    gen = torch.Generator().manual_seed(seed)
    x = (torch.rand(b, h, w, c0, generator=gen) * 2 - 1).to(
        torch.bfloat16).cuda()
    low = None if not c1 else (torch.rand(
        b, h // 2, w // 2, c1, generator=gen) * 2 - 1).to(torch.bfloat16).cuda()
    wts = []
    for cin, co in ((c0 + c1, mid), (mid, cout)):
        wts.append((torch.randn(co, cin, 3, 3, generator=gen)
                    / (9 * cin) ** 0.5).cuda())
        wts.append((0.1 * torch.randn(co, generator=gen)).cuda())
    return x, low, wts


def check_dconv(b, h, w, c0, c1, mid, cout, align_corners=False,
                dtype=torch.bfloat16) -> float:
    """The double_conv kernel (c1 == 0) or the up block (c1 > 0) vs its
    plain version on the card, within FLOAT_BOUND (the outputs stay under
    4 in magnitude, so 2 bf16 ulp). ``align_corners``: the option core's
    align-corners composition, the up block as ``_upsample2x_t`` and the
    double-conv kernel on the concat. In f32 (``dtype``): the direct-conv
    route, two launches, within F32_BOUND of the plain version with TF32
    off."""
    from ai_based_frame_interpolation_torch.models.core_t import _upsample2x_t
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, double_conv_reference, pack_dconv_weights,
        up_double_conv_fused, up_double_conv_reference)

    x, low, wts = dconv_inputs(b, h, w, c0, c1, mid, cout, seed=h + w + c0)
    f32 = dtype == torch.float32
    if f32:
        x, low = x.float(), None if low is None else low.float()
    up_block = c1 and not align_corners
    packed = pack_dconv_weights(*wts, split=c0 if up_block else None,
                                compute_dtype=dtype)
    before, routes = counts(), route_counts()
    if up_block:
        got = up_double_conv_fused(x, low, *wts, dtype, packed)
        with no_tf32():
            want = up_double_conv_reference(x, low, *wts, dtype)
        expect = {"up_double_conv": 1}
    else:
        if align_corners:
            x = torch.cat([x, _upsample2x_t(low)], -1)
        got = double_conv_fused(x, *wts, dtype, packed)
        with no_tf32():
            want = double_conv_reference(x, *wts, dtype)
        expect = {"double_conv": 1}
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in counts().items()}
    route = (f"{next(iter(expect))} {'direct' if f32 else 'fused'}",
             2 if f32 else 1)
    expect = dict(NO_LAUNCHES, **({"conv_direct": 2} if f32 else expect))
    assert n == expect, f"the double_conv route launched {n}, not {expect}"
    got_routes = {k: v - routes.get(k, 0) for k, v in route_counts().items()
                  if v != routes.get(k, 0)}
    assert got_routes == dict([route]), f"double_conv routes {got_routes}"
    err = float((got.float() - want.float()).abs().max())
    print(f"{'up_' if up_block else ''}double_conv"
          f"{' align-corners composition' if align_corners else ''} "
          f"{'f32 (direct) ' if f32 else ''}B={b} "
          f"{h}x{w} {c0}+{c1}->{mid}->{cout}: max|kernel-plain|={err:.6g} "
          f"differing {float((got != want).float().mean()):.6g} max|plain|="
          f"{float(want.float().abs().max()):.4g}", flush=True)
    assert got.shape == want.shape == (b, h, w, cout)
    assert got.dtype == dtype and bool(torch.isfinite(got.float()).all())
    assert err <= (F32_BOUND if f32 else FLOAT_BOUND), \
        f"double_conv kernel disagrees by {err}"
    return err


# the option core's levels at b8 1080p (s2d 4, base 64): (B, H, W, skip or
# input channels, low channels, mid, out)
CORE_LEVELS = {"inc": (8, 272, 480, 32, 0, 64, 64),
               "down1": (8, 136, 240, 64, 0, 128, 128),
               "down2": (8, 68, 120, 128, 0, 256, 256),
               "up3": (8, 136, 240, 128, 128, 128, 64),
               "up4": (8, 272, 480, 64, 64, 64, 64)}


def check_core_kernels(record) -> None:
    """Phase 2's option-core part: the five levels at b8 1080p, heights and
    widths off the 16x16 tile, a 7-row image, uneven channel counts (not
    multiples of 16), and the align-corners composition; in f32 the five
    levels at b2 1080p (the f32 engine's), two at b8 and the odd shapes."""
    errs = {name: check_dconv(*shape) for name, shape in CORE_LEVELS.items()}
    errs["odd_2x19x37_24-40-8"] = check_dconv(2, 19, 37, 24, 0, 40, 8)
    errs["rows7_1x7x9_32-16-16"] = check_dconv(1, 7, 9, 32, 0, 16, 16)
    errs["up_odd_2x18x34_16+8-16-8"] = check_dconv(2, 18, 34, 16, 8, 16, 8)
    errs["up_odd_1x14x22_8+24-24-8"] = check_dconv(1, 14, 22, 8, 24, 24, 8)
    errs["align_corners_2x64x120_64+64-64-64"] = check_dconv(
        2, 64, 120, 64, 64, 64, 64, align_corners=True)
    # f32: the five levels at the f32 engine's b2 1080p, down1 and up3 at
    # b8, and the odd shapes
    f32 = {f"f32_{name}_b2": check_dconv(2, *shape[1:], dtype=torch.float32)
           for name, shape in CORE_LEVELS.items()}
    f32.update({
        "f32_down1": check_dconv(*CORE_LEVELS["down1"], dtype=torch.float32),
        "f32_up3": check_dconv(*CORE_LEVELS["up3"], dtype=torch.float32),
        "f32_odd_2x19x37_24-40-8": check_dconv(2, 19, 37, 24, 0, 40, 8,
                                               dtype=torch.float32),
        "f32_up_odd_2x18x34_16+8-16-8": check_dconv(
            2, 18, 34, 16, 8, 16, 8, dtype=torch.float32)})
    record["dconv_f32_errs"] = f32
    record["dconv_errs"] = errs
    record["double_conv_max_abs_err"] = max(
        e for k, e in errs.items() if "up" not in k)
    record["up_double_conv_max_abs_err"] = max(
        e for k, e in errs.items() if "up" in k)


def frames(n, h, w, seed):
    """Structured gray frames (a moving pattern plus noise), uint8 NHWC."""
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    out1, out2 = [], []
    for i in range(n):
        base = 127 + 90 * np.sin((x + 7 * i) / 23.0) * np.cos(y / 17.0)
        noise = gen.normal(0, 8, (h, w))
        out1.append(base + noise)
        out2.append(np.roll(base, 6, axis=1) + noise)
    f1 = np.clip(np.stack(out1), 0, 255).astype(np.uint8)[..., None]
    f2 = np.clip(np.stack(out2), 0, 255).astype(np.uint8)[..., None]
    return f1, f2


def filtered_png(img, kinds) -> bytes:
    """HWC uint8 -> PNG bytes whose row y is stored under filter
    ``kinds[y]`` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth), the filters
    applied here with numpy (the card's machine has no OpenCV)."""
    from ai_based_frame_interpolation_torch.ops.png import png_from_scanlines

    h, w, c = img.shape
    x = img.reshape(h, w * c).astype(np.int16)
    left = np.pad(x, ((0, 0), (c, 0)))[:, :-c]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(x, ((1, 0), (c, 0)))[:-1, :-c]
    pa, pb, pc = (np.abs(up - upleft), np.abs(left - upleft),
                  np.abs(left + up - 2 * upleft))
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    preds = np.stack([np.zeros_like(x), left, up, (left + up) >> 1, paeth])
    kinds = np.asarray(kinds)
    rows = np.empty((h, w * c + 1), np.uint8)
    rows[:, 0] = kinds
    rows[:, 1:] = (x - preds[kinds, np.arange(h)]) & 0xFF
    return png_from_scanlines(rows, w, c)


def refilter_tree(src, dst) -> None:
    """Copy the fixture at ``src`` to ``dst`` with each PNG re-encoded so
    that row y has filter y % 5, checking that it decodes to the same
    pixels."""
    from ai_based_frame_interpolation_torch.ops.png import decode_png

    for video in sorted(os.listdir(src)):
        os.makedirs(os.path.join(dst, video))
        for name in sorted(os.listdir(os.path.join(src, video))):
            with open(os.path.join(src, video, name), "rb") as f:
                img = decode_png(f.read())
            data = filtered_png(img, np.arange(img.shape[0]) % 5)
            assert np.array_equal(decode_png(data), img), name
            with open(os.path.join(dst, video, name), "wb") as f:
                f.write(data)


def plain_core(model, x1, x2) -> torch.Tensor:
    """The option core (``models/core_t.py:forward_pre_refine``) composed
    here from the port's modules with the kernels' plain versions at the
    five outer levels, for the checks only: the f32 NCHW pre-refine
    prediction."""
    from ai_based_frame_interpolation_torch.models.core_t import (
        _pool2, _s2d_nhwc, _upsample2x_t)
    from ai_based_frame_interpolation_torch.models.unet import depth_to_space
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_reference, up_double_conv_reference)

    cfg, cdt, u = model.cfg, model.compute_dtype, model.unet
    r = cfg.space_to_depth

    def dconv(dc, x):
        return double_conv_reference(x, dc.conv1.weight, dc.conv1.bias,
                                     dc.conv2.weight, dc.conv2.bias, cdt)

    def up(dc, skip, low):
        if cfg.upsample == "align_corners":
            return dconv(dc, torch.cat([skip, _upsample2x_t(low)], -1))
        return up_double_conv_reference(skip, low, dc.conv1.weight,
                                        dc.conv1.bias, dc.conv2.weight,
                                        dc.conv2.bias, cdt)

    f1, f2 = _s2d_nhwc(x1, r), _s2d_nhwc(x2, r)
    s0 = dconv(u.inc, torch.cat([f1.to(cdt), f2.to(cdt)], -1))
    s1 = dconv(u.down1.conv, _pool2(s0))
    s2 = dconv(u.down2.conv, _pool2(s1)).permute(0, 3, 1, 2)
    s3 = u.down3(s2, cdt)
    y = u.up2(u.up1(u.down4(s3, cdt), s3, cdt), s2, cdt).permute(0, 2, 3, 1)
    y = up(u.up4.conv, s0, up(u.up3.conv, s1, y))
    y = torch.nn.functional.conv2d(y.permute(0, 3, 1, 2).float(),
                                   u.outc.weight.float(), u.outc.bias.float())
    if cfg.residual:
        y = y + 0.5 * (f1 + f2).permute(0, 3, 1, 2).to(y.dtype)
    return depth_to_space(y, r)


def reference_midpoints(engine, f1, f2, core=False) -> torch.Tensor:
    """The engine's 2x path composed from the same port modules with the
    plain refinement head (and with ``core`` the option core on its plain
    versions), for the check only."""
    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8, normalize_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head_reference)
    from ai_based_frame_interpolation_torch.ops.resize import (
        crop_to, pad_to_multiple)

    cdt, model = engine.compute_dtype, engine.model
    with torch.inference_mode():
        x1, hw = pad_to_multiple(normalize_uint8(
            engine._put(f1).permute(0, 3, 1, 2), cdt), engine.cfg.pad_multiple)
        x2, _ = pad_to_multiple(normalize_uint8(
            engine._put(f2).permute(0, 3, 1, 2), cdt), engine.cfg.pad_multiple)
        if core:
            y = plain_core(model, x1, x2)
        else:
            y = model(x1, x2, skip_refine=True)
        out = refine_head_reference(
            y.permute(0, 2, 3, 1), (x1.permute(0, 2, 3, 1),
                                    x2.permute(0, 2, 3, 1)),
            model.head_params(), cdt).permute(0, 3, 1, 2)
        return denormalize_to_uint8(crop_to(out, hw)).permute(0, 2, 3, 1)


def reference_flow(engine, f1, f2, ts) -> torch.Tensor:
    """The flow engine's samples at times ``ts`` composed from the same
    port modules with the plain sampler and head, for the check only."""
    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head_reference)
    from ai_based_frame_interpolation_torch.ops.resize import crop_to
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        sample_fused_reference)

    cdt, model = engine.compute_dtype, engine.model
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    with torch.inference_mode():
        x1, hw = engine._prep(engine._put(f1))
        x2, _ = engine._prep(engine._put(f2))
        flow, mask = model.motion(x1, x2)
        outs = []
        for t in ts:
            tt = torch.full((x1.shape[0],), t, dtype=torch.float32,
                            device=x1.device)
            out, g0, g1 = sample_fused_reference(
                nhwc(x1), nhwc(x2), nhwc(flow), nhwc(mask), tt,
                engine.cfg.max_flow)
            y = refine_head_reference(out, (g0, g1, nhwc(x1), nhwc(x2)),
                                      model.head_params(), cdt)
            outs.append(crop_to(y.permute(0, 3, 1, 2), hw))
        out = denormalize_to_uint8(torch.stack(outs, 1))
        return out.permute(0, 1, 3, 4, 2)


def head_flops_bytes(b, h, w, c, nplanes, width=64, nf32=0, depthwise=False,
                     elem=2):
    """Tensor-core FLOPs, f32 CUDA-core FLOPs and device bytes of the head:
    every input read once (``nf32`` of the planes besides the prediction in
    f32, the rest bf16), the output (``elem`` bytes: 2 bf16, 4 f32)
    written once, the weights read once. The depthwise head's 3x3 (9
    multiply-adds a channel) is its f32 work; its pointwise conv is a
    width x width GEMM."""
    px = b * h * w
    conv2 = width * width if depthwise else 9 * width * width
    flops = 2 * px * (9 * nplanes * width + conv2 + width * c)
    f32_flops = 2 * px * 9 * width if depthwise else 0
    weights = 2 * (9 * nplanes * width + width + conv2 + width) \
        + 4 * (width * c + c) + (6 * 9 * width if depthwise else 0)
    byts = px * (4 * c + 4 * nf32 * c + 2 * (nplanes - c - nf32 * c)
                 + elem * c) + weights
    return flops, f32_flops, byts


def dconv_flops_bytes(b, h, w, c0, c1, mid, cout, elem=2):
    """FLOPs and device bytes of a double conv (c1 == 0) or up block: the
    input (and ``low`` at half size) read once, the output written once,
    the weights and biases read once, ``elem`` bytes each (2 bf16, 4
    f32)."""
    px = b * h * w
    cin = c0 + c1
    flops = 2 * px * 9 * (cin * mid + mid * cout)
    byts = elem * (px * (c0 + cout) + px // 4 * c1
                   + 9 * (cin * mid + mid * cout) + mid + cout)
    return flops, byts


def sampler_flops_bytes(b, h, w, c, img_bytes=2):
    """FLOPs and device bytes of the sampler: f1 and f2, the two flow
    planes, the mask and t read once, out, g0 and g1 (f32) written once.
    Per pixel and warp, three taps (mul, add, sub: 9) and three lerps per
    channel (4 each); the blend 6 + 4 per channel."""
    px = b * h * w
    flops = px * (2 * (9 + 12 * c) + 6 + 4 * c)
    byts = px * (2 * img_bytes * c + 8 + 4 + 12 * c) + 4 * b
    return flops, byts


def bound(flops, byts, peak_flops, f32_flops=0):
    """(bound ms, what bounds it) on the H100's published peaks; ``f32_flops``
    run on the CUDA cores beside ``flops`` at ``peak_flops``."""
    t_ops = max(flops / peak_flops, f32_flops / H100_F32_FLOPS)
    t_bytes = byts / H100_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, \
        ("operations" if t_ops >= t_bytes else "bytes")


def ssim_flops_bytes(b, h, w, c):
    """FLOPs and device bytes of the SSIM of uint8 images: SSIM_FLOPS_PER_PX
    per valid position, both images read once, [B] f32 written once."""
    flops = SSIM_FLOPS_PER_PX * b * c * max(h - 6, 0) * max(w - 6, 0)
    return flops, 2 * b * h * w * c + 4 * b


def _counted():
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        conv_direct, head_out_direct)
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, up_double_conv_fused)
    from ai_based_frame_interpolation_torch.ops.refine import refine_head
    from ai_based_frame_interpolation_torch.ops.ssim_fused import (
        ssim_eval_fused)
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        sample_fused)

    return {"refine_head": refine_head, "sample_fused": sample_fused,
            "ssim_eval": ssim_eval_fused, "double_conv": double_conv_fused,
            "up_double_conv": up_double_conv_fused,
            "conv_direct": conv_direct, "head_out_direct": head_out_direct}


def reset_counts() -> None:
    for fn in _counted().values():
        fn.launches = 0
        if hasattr(fn, "routes"):
            fn.routes.clear()


def counts() -> dict:
    return {name: fn.launches for name, fn in _counted().items()}


def route_counts() -> dict:
    """The launches each wrapper that picks a route counted under it:
    ``"refine_head w64/w32/bfloat16"`` (route/model width/dtype),
    ``"double_conv direct"``."""
    return {f"{name} {key}": n for name, fn in _counted().items()
            for key, n in getattr(fn, "routes", {}).items() if n}


# every route's launches over the main-path runs (phases 3, 4 and 6), each
# run read once after its counts were set to 0 (main_counts)
MAIN_ROUTES = collections.Counter()


def main_counts() -> dict:
    """counts() after a main-path run; its route counts go to MAIN_ROUTES."""
    MAIN_ROUTES.update(route_counts())
    return counts()


NO_LAUNCHES = dict.fromkeys(("refine_head", "sample_fused", "ssim_eval",
                             "double_conv", "up_double_conv", "conv_direct",
                             "head_out_direct"), 0)


def build(record) -> None:
    """Every kernel source, one nvcc each, all at once."""
    from ai_based_frame_interpolation_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"kernel build {record['build_s']:.1f} s "
          f"({', '.join(_build.sources())})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)


# (B, H, W, C, element offset) where the head's tile loop can break: tiles
# on a batch boundary (B=3: the rows above image b are zeros, not image
# b-1's), widths not a multiple of 8 (rows off 16-byte alignment, gray and
# RGB), an image smaller than a tile (fewer tiles than a block's groups),
# and planes at a data pointer that is not 16-byte aligned
EDGE_SHAPES = [(3, 40, 72, 1, 0), (2, 37, 53, 1, 0), (1, 21, 45, 3, 0),
               (1, 7, 9, 1, 0), (2, 40, 72, 1, 1), (1, 21, 45, 3, 1)]


def check_heads(record) -> None:
    """The fused head's three instances against the plain head."""
    # w64: the U-Net path's shapes (8x1088x1920; the batcher's 4x256x256),
    # one 1080p frame, widths 128/256, heights that are not a multiple of
    # 16, RGB (9 planes) and 5 planes; every instance also at EDGE_SHAPES
    shapes = [(8, 1088, 1920, 1, 2), (4, 256, 256, 1, 2), (1, 1088, 1920, 1, 2),
              (2, 72, 128, 1, 2), (2, 40, 256, 1, 2), (1, 40, 72, 3, 2),
              (2, 56, 96, 1, 4)]
    errs = [check_kernel(s) for s in shapes]
    errs += [check_kernel((b, h, w, c, 2), offset=off)
             for b, h, w, c, off in EDGE_SHAPES]
    # RGB, 4 frames besides the prediction, 2 of them f32 (15 planes): two
    # groups do not fit, one does
    errs.append(check_kernel((1, 40, 72, 3, 4), nf32=2))
    record["refine_head_w64_max_abs_err"] = max(errs)
    # w16: the flow path's 5 planes with f32 g0/g1 (8x1088x1920, the
    # batcher's 256x256), small widths, heights 40 and 50, RGB (15 planes),
    # and all-bf16 planes
    shapes = [(8, 1088, 1920, 1, 4), (4, 256, 256, 1, 4), (2, 72, 128, 1, 4),
              (2, 40, 256, 1, 4), (1, 40, 72, 3, 4), (2, 50, 96, 1, 4)]
    errs = [check_kernel(s, width=16, nf32=2) for s in shapes]
    errs.append(check_kernel((2, 56, 96, 1, 4), width=16))
    errs += [check_kernel((b, h, w, c, 4), width=16, nf32=2, offset=off)
             for b, h, w, c, off in EDGE_SHAPES + [(2, 37, 53, 3, 0)]]
    record["refine_head_w16_max_abs_err"] = max(errs)
    # the depthwise head: the U-Net path's 8x1088x1920 and one frame, off
    # the tile (40x72), RGB (9 planes)
    shapes = [(8, 1088, 1920, 1, 2), (1, 1088, 1920, 1, 2), (2, 40, 72, 1, 2),
              (1, 40, 72, 3, 2)]
    errs = [check_kernel(s, depthwise=True) for s in shapes]
    errs += [check_kernel((b, h, w, c, 2), depthwise=True, offset=off)
             for b, h, w, c, off in EDGE_SHAPES]
    record["refine_head_dw_max_abs_err"] = max(errs)


def check_kernels(record) -> None:
    """Each kernel against its plain version on the card."""
    check_heads(record)
    check_samplers(record)
    check_ssim_kernels(record)
    check_core_kernels(record)
    check_head_routes(record)
    check_direct_modes(record)


def serve_requests(engine, seed) -> dict:
    """8 concurrent 256x256 requests (num 1 and 3) through the batcher."""
    from ai_based_frame_interpolation_torch.serve.batcher import (
        DynamicBatcher)

    batcher = DynamicBatcher(engine, max_batch=8)
    r1, r2 = frames(8, 256, 256, seed=seed)
    nums = [1 + 2 * (i % 2) for i in range(8)]
    answers = [None] * 8
    errors = []
    gate = threading.Barrier(8)

    def request(i):
        try:
            gate.wait(timeout=60)
            answers[i] = batcher.generate_intermediate_frames(r1[i], r2[i],
                                                              nums[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    reset_counts()
    threads = [threading.Thread(target=request, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads), "a request hung"
    if errors:
        raise errors[0]
    for i, ans in enumerate(answers):
        assert len(ans) == nums[i] and all(
            a.shape == (256, 256, 1) and a.dtype == np.uint8 for a in ans)
    launches = main_counts()
    print(f"requests: 8 answered, batcher {batcher.stats}, launches "
          f"{launches}", flush=True)
    return dict(batcher.stats, launches=launches)


def unet_path(record):
    """The U-Net path: full-width production engine, 1080p gray 2x, b=8,
    counts set to 0 just before and read just after."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    engine = InterpolationEngine.random_init(ModelConfig(**PROD), seed=0)
    f1, f2 = frames(8, 1080, 1920, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.interpolate_batch(f1, f2)
    main_s = time.perf_counter() - t0
    launches = main_counts()
    print(f"U-Net path: interpolate_batch b=8 1080x1920 -> {out.shape} "
          f"{out.dtype} in {main_s:.3f} s (first call); launches {launches}",
          flush=True)
    assert launches["refine_head"] > 0, \
        "the U-Net path did not run the refine_head kernel"
    assert out.shape == (8, 1080, 1920, 1) and out.dtype == np.uint8
    want = reference_midpoints(engine, f1, f2).cpu().numpy()
    du = np.abs(out.astype(np.int16) - want.astype(np.int16))
    print(f"U-Net path vs plain head: max uint8 diff {int(du.max())}, "
          f"differing {float((du > 0).mean()):.6g}, mean output "
          f"{float(out.mean()):.3f}", flush=True)
    assert int(du.max()) <= 1
    record["main_path"] = {"batch": 8, "hw": [1080, 1920],
                           "launches": launches,
                           "max_uint8_diff_vs_plain": int(du.max()),
                           "uint8_differing_share": float((du > 0).mean())}
    record["requests"] = serve_requests(engine, seed=2)
    assert record["requests"]["launches"]["refine_head"] > 0
    return engine, launches, out


def core_path(record, xla_out, upsample="half_pixel"):
    """The U-Net path on the option core: the production engine (with the
    given decoder ``upsample``) with ``core_impl="pallas"`` on the same
    weights and frames as the default route (``xla_out``; for another
    decoder, an engine of that decoder on the default route), counts set
    to 0 just before and read just after; within 1 LSB of the same modules
    composed with the plain versions and of the default route. The
    half-pixel decoder runs 3 double_conv and 2 up_double_conv launches
    per dispatch; the align-corners one 5 double_conv on the concat."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    cfg = ModelConfig(**dict(PROD, upsample=upsample))
    engine = InterpolationEngine.random_init(cfg, seed=0, core_impl="pallas")
    f1, f2 = frames(8, 1080, 1920, seed=1)
    if xla_out is None:
        xla_out = InterpolationEngine.random_init(cfg, seed=0) \
            .interpolate_batch(f1, f2)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.interpolate_batch(f1, f2)
    main_s = time.perf_counter() - t0
    launches = main_counts()
    print(f"U-Net option core ({upsample}): interpolate_batch b=8 "
          f"1080x1920 -> {out.shape} {out.dtype} in {main_s:.3f} s (first "
          f"call); launches {launches}", flush=True)
    want_launches = dict(NO_LAUNCHES, double_conv=3, up_double_conv=2,
                         refine_head=1) if upsample == "half_pixel" else \
        dict(NO_LAUNCHES, double_conv=5, refine_head=1)
    assert launches == want_launches, \
        f"the option core ({upsample}) launched {launches}, not " \
        f"{want_launches}, in one dispatch"
    assert out.shape == (8, 1080, 1920, 1) and out.dtype == np.uint8
    want = reference_midpoints(engine, f1, f2, core=True).cpu().numpy()
    du = np.abs(out.astype(np.int16) - want.astype(np.int16))
    dx = np.abs(out.astype(np.int16) - xla_out.astype(np.int16))
    print(f"U-Net option core ({upsample}) vs plain core and head: max "
          f"uint8 diff {int(du.max())}, differing "
          f"{float((du > 0).mean()):.6g}; vs the default route: max "
          f"{int(dx.max())}, differing {float((dx > 0).mean()):.6g}; mean "
          f"output {float(out.mean()):.3f}", flush=True)
    assert int(du.max()) <= 1 and int(dx.max()) <= 1
    key = "core_path" if upsample == "half_pixel" else f"core_path_{upsample}"
    record[key] = {"batch": 8, "hw": [1080, 1920], "launches": launches,
                   "max_uint8_diff_vs_plain": int(du.max()),
                   "uint8_differing_share": float((du > 0).mean()),
                   "max_uint8_diff_vs_xla": int(dx.max()),
                   "uint8_differing_share_vs_xla": float((dx > 0).mean())}
    return engine, launches


def depthwise_path(record):
    """The U-Net path with the depthwise head (``refine_depthwise=True``),
    counts set to 0 just before and read just after; within 1 LSB of the
    same modules composed with the plain head."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    engine = InterpolationEngine.random_init(
        ModelConfig(**PROD, refine_depthwise=True), seed=0)
    f1, f2 = frames(8, 1080, 1920, seed=1)
    reset_counts()
    out = engine.interpolate_batch(f1, f2)
    launches = main_counts()
    assert launches == dict(NO_LAUNCHES, refine_head=1), \
        f"the depthwise head path launched {launches}"
    assert out.shape == (8, 1080, 1920, 1) and out.dtype == np.uint8
    want = reference_midpoints(engine, f1, f2).cpu().numpy()
    du = np.abs(out.astype(np.int16) - want.astype(np.int16))
    print(f"U-Net depthwise head: b=8 1080x1920, launches {launches}; vs "
          f"plain head: max uint8 diff {int(du.max())}, differing "
          f"{float((du > 0).mean()):.6g}, mean output {float(out.mean()):.3f}",
          flush=True)
    assert int(du.max()) <= 1
    record["depthwise_path"] = {"batch": 8, "hw": [1080, 1920],
                                "launches": launches,
                                "max_uint8_diff_vs_plain": int(du.max()),
                                "uint8_differing_share":
                                    float((du > 0).mean())}
    return engine, launches


def f32_path(record):
    """The f32 production U-Net engine (``compute_dtype=torch.float32``),
    b2 1080p, on the default route (cuDNN's f32 core; the head on the
    direct convs: 2 conv_direct + 1 head_out_direct launches) and on the
    option core (the five outer levels on the direct convs too: 12 + 1),
    each with the counts set to 0 just before and read just after; within
    1 LSB of the same modules composed with the plain versions, and the
    two routes within 1 LSB of each other. TF32 is off for the whole phase
    (engines and plain side): with cuDNN's default TF32 the default route
    is not an f32 computation."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    f1, f2 = frames(2, 1080, 1920, seed=1)
    outs, result = {}, {"batch": 2, "hw": [1080, 1920], "tf32": False}
    # the head: conv1, conv2, out; the option core: two convs at each of
    # inc, down1, down2 and up3, up4
    head = {"refine_head direct/w64/float32": 3}
    want_routes = {"xla": head, "pallas": dict(
        head, **{"double_conv direct": 6, "up_double_conv direct": 4})}
    with no_tf32():
        for impl, expect in (("xla", dict(NO_LAUNCHES, conv_direct=2,
                                           head_out_direct=1)),
                             ("pallas", dict(NO_LAUNCHES, conv_direct=12,
                                             head_out_direct=1))):
            engine = InterpolationEngine.random_init(
                ModelConfig(**PROD), seed=0, compute_dtype=torch.float32,
                core_impl=impl)
            reset_counts()
            out = engine.interpolate_batch(f1, f2)
            routes = route_counts()
            launches = main_counts()
            assert launches == expect, \
                f"the f32 engine ({impl}) launched {launches}, not {expect}"
            assert routes == want_routes[impl], \
                f"the f32 engine ({impl}) routes {routes}"
            assert out.shape == (2, 1080, 1920, 1) and out.dtype == np.uint8
            want = reference_midpoints(engine, f1, f2,
                                       core=impl == "pallas").cpu().numpy()
            du = np.abs(out.astype(np.int16) - want.astype(np.int16))
            print(f"f32 U-Net engine ({impl}): b=2 1080x1920, launches "
                  f"{launches}; vs plain: max uint8 diff {int(du.max())}, "
                  f"differing {float((du > 0).mean()):.6g}, mean output "
                  f"{float(out.mean()):.3f} (TF32 off)", flush=True)
            assert int(du.max()) <= 1
            outs[impl] = out
            result[impl] = {"launches": launches, "routes": routes,
                            "max_uint8_diff_vs_plain": int(du.max()),
                            "uint8_differing_share": float((du > 0).mean())}
            del engine
    dx = np.abs(outs["pallas"].astype(np.int16) - outs["xla"].astype(np.int16))
    print(f"f32 U-Net engine: option core vs default route: max uint8 diff "
          f"{int(dx.max())}, differing {float((dx > 0).mean()):.6g}",
          flush=True)
    assert int(dx.max()) <= 1
    result["max_uint8_diff_pallas_vs_xla"] = int(dx.max())
    record["f32_path"] = result
    return result


def flow_path(record):
    """The flow path: full-width flow production engine, 1080p gray 2x,
    b=8, counts set to 0 just before and read just after; then 3
    in-betweens, two arbitrary times and the batcher."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    engine = InterpolationEngine.random_init(ModelConfig(**FLOW_PROD), seed=0)
    f1, f2 = frames(8, 1080, 1920, seed=1)
    reset_counts()
    t0 = time.perf_counter()
    out = engine.interpolate_batch(f1, f2)
    main_s = time.perf_counter() - t0
    launches = main_counts()
    print(f"flow path: interpolate_batch b=8 1080x1920 -> {out.shape} "
          f"{out.dtype} in {main_s:.3f} s (first call); launches {launches}",
          flush=True)
    assert launches == dict(NO_LAUNCHES, refine_head=1, sample_fused=1), \
        "the flow path must launch each kernel once per dispatch"
    assert out.shape == (8, 1080, 1920, 1) and out.dtype == np.uint8
    want = reference_flow(engine, f1, f2, [0.5])[:, 0].cpu().numpy()
    du = np.abs(out.astype(np.int16) - want.astype(np.int16))
    print(f"flow path vs plain sampler and head: max uint8 diff "
          f"{int(du.max())}, differing {float((du > 0).mean()):.6g}, mean "
          f"output {float(out.mean()):.3f}", flush=True)
    assert int(du.max()) <= 1
    record["flow_path"] = {"batch": 8, "hw": [1080, 1920],
                           "launches": launches,
                           "max_uint8_diff_vs_plain": int(du.max()),
                           "uint8_differing_share": float((du > 0).mean())}

    # 3 in-betweens at t = 1/4, 1/2, 3/4 and two arbitrary times, one pair
    for name, run, ts in (
            ("generate_intermediate_frames(3)",
             lambda: engine.generate_intermediate_frames(f1[0], f2[0], 3),
             [0.25, 0.5, 0.75]),
            ("interpolate_at([0.3, 0.7])",
             lambda: engine.interpolate_at(f1[0], f2[0], [0.3, 0.7]),
             [0.3, 0.7])):
        reset_counts()
        got = np.stack(run())
        n = main_counts()
        want = reference_flow(engine, f1[:1], f2[:1], ts)[0].cpu().numpy()
        du = int(np.abs(got.astype(np.int16) - want.astype(np.int16)).max())
        print(f"flow {name}: {got.shape}, launches {n}, max uint8 diff vs "
              f"plain {du}", flush=True)
        assert got.shape == (len(ts), 1080, 1920, 1) and du <= 1
        assert n == dict(NO_LAUNCHES, refine_head=len(ts),
                         sample_fused=len(ts))
        record["flow_path"][name] = {"launches": n, "max_uint8_diff": du}
    record["flow_requests"] = serve_requests(engine, seed=4)
    assert record["flow_requests"]["launches"]["sample_fused"] > 0
    return engine, launches


@contextlib.contextmanager
def eval_timers(harness, engine, split):
    """Host clocks around the harness's decode, the engine and the metrics
    (each returns host arrays, so its device work is inside); yields the
    (predictions, ground truths) of every metric call, in order."""
    load, metrics = harness.load_triplet_arrays, harness._batched_metrics
    interpolate = engine.interpolate_batch
    batches = []

    def timed(key, fn):
        def run(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            split[key] += time.perf_counter() - t0
            return out
        return run

    timed_metrics = timed("metric_s", metrics)

    def kept_metrics(preds, gts, device):
        batches.append((preds.copy(), gts.copy()))
        return timed_metrics(preds, gts, device)

    harness.load_triplet_arrays = timed("decode_s", load)
    harness._batched_metrics = kept_metrics
    engine.interpolate_batch = timed("engine_s", interpolate)
    try:
        yield batches
    finally:
        harness.load_triplet_arrays, harness._batched_metrics = load, metrics
        del engine.interpolate_batch


def device_busy_ms(fn):
    """(host ms, device busy ms) of one call of ``fn`` under torch.profiler:
    the device time of every kernel and copy; None if the profiler
    recorded no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us = sum(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0))
                  for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA)
    return wall_ms, (busy_us / 1e3 if busy_us > 0 else None)


def kernel_device_ms(fn, names, iters: int, parts=None):
    """Device ms per call of ``fn`` in the kernels whose name holds one of
    ``names``, by torch.profiler over ``iters`` calls after a warm-up (the
    kernels' own time, without the host's launch cost); None if the
    profiler recorded none. ``parts``: a dict that receives the ms per
    call of each kernel, by its function name."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):          # a window now and then records no kernel
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [ev for ev in prof.key_averages()
                  if ev.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    us = 0.0
    for ev in events:
        if not any(n in ev.key for n in names):
            continue
        t = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        us += t
        if parts is not None:
            key = ev.key.replace("(anonymous namespace)::", "")
            found = re.search(r"([A-Za-z_]\w*)\s*[<(]", key)
            name = found.group(1) if found else key[:40]
            parts[name] = parts.get(name, 0.0) + t / 1e3 / iters
    return us / 1e3 / iters if us > 0 else None


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:.4f} ms"


def run_eval(label, engine, root, hw, expect, out_dir) -> dict:
    """``evaluate_model(methods=("unet", "linear"), batch_size=8)`` over the
    fixture at ``root``: launch counts, every per-triplet metric against the
    plain metrics on the same arrays (ground truths loaded again), the
    reports, then a second (warm) call split into decode, engine and metric
    time, and a third under the profiler for the device's busy time."""
    from ai_based_frame_interpolation_torch.eval import harness, report
    from ai_based_frame_interpolation_torch.ops.image import load_image
    from ai_based_frame_interpolation_torch.ops.psnr import psnr
    from ai_based_frame_interpolation_torch.ops.ssim import ssim_eval

    def evaluate(split):
        with eval_timers(harness, engine, split) as batches:
            t0 = time.perf_counter()
            res = harness.evaluate_model(engine, test_dir=root,
                                         methods=("unet", "linear"),
                                         batch_size=8, height=hw[0],
                                         width=hw[1])
            split["total_s"] = time.perf_counter() - t0
        return res, batches

    first = dict(decode_s=0.0, engine_s=0.0, metric_s=0.0)
    reset_counts()
    res, batches = evaluate(first)
    launches = main_counts()
    print(f"eval {label}: {res['num_triplets']} triplets, launches "
          f"{launches} (first call {first['total_s']:.3f} s)", flush=True)
    assert launches == expect, f"eval {label}: launches {launches} != {expect}"

    methods = res["methods"]
    assert methods == ["unet", "linear"]
    taken = {m: 0 for m in methods}
    dpsnr = dssim = 0.0
    for k, (pred, gt) in enumerate(batches):
        m = methods[k % len(methods)]
        rows = res["results_by_method"][m][taken[m]:taken[m] + len(pred)]
        taken[m] += len(pred)
        for row, g in zip(rows, gt, strict=True):
            again = load_image(os.path.join(row["video_dir"],
                                            row["ground_truth"]), size=hw)
            assert np.array_equal(again, g)
        want_p = psnr(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
        want_s = ssim_eval(torch.from_numpy(pred).cuda(),
                           torch.from_numpy(gt).cuda()).cpu().numpy()
        dpsnr = max(dpsnr, float(np.abs(
            np.array([r["psnr"] for r in rows]) - want_p).max()))
        dssim = max(dssim, float(np.abs(
            np.array([r["ssim"] for r in rows]) - want_s).max()))
    assert all(taken[m] == res["num_triplets"] for m in methods)
    assert dpsnr <= PSNR_BOUND_DB, f"PSNR off the plain psnr by {dpsnr} dB"
    assert dssim <= SSIM_BOUND, f"SSIM off the plain ssim_eval by {dssim}"

    os.makedirs(out_dir, exist_ok=True)
    paths = (report.save_json(res, os.path.join(out_dir, "results.json")),
             report.save_csv_summary(res, os.path.join(out_dir, "summary.csv")),
             report.write_markdown_report(res, os.path.join(out_dir,
                                                            "report.md")))
    with open(paths[0]) as f:
        assert json.load(f) == json.loads(json.dumps(res))
    with open(paths[1]) as f:
        lines = f.read().splitlines()
    assert lines[0].startswith("method,psnr_avg,psnr_std") and \
        [ln.split(",")[0] for ln in lines[1:]] == methods
    with open(paths[2]) as f:
        assert "## Rankings" in f.read()

    warm = dict(decode_s=0.0, engine_s=0.0, metric_s=0.0)
    evaluate(warm)
    profiled_ms, busy_ms = device_busy_ms(
        lambda: evaluate(dict(decode_s=0.0, engine_s=0.0, metric_s=0.0)))
    busy = ("no device time recorded" if busy_ms is None else
            f"{busy_ms:.3f} ms ({100 * busy_ms / profiled_ms:.2f}%)")
    print(f"eval {label}: profiled call {profiled_ms:.3f} ms, device busy "
          f"{busy}", flush=True)
    mm = res["metrics_by_method"]
    print(f"eval {label}: " + ", ".join(
        f"{m} PSNR {mm[m]['psnr']['avg']:.4f} dB SSIM {mm[m]['ssim']['avg']:.6f}"
        for m in methods) + f"; vs plain: max |dPSNR| {dpsnr:.3g} dB, max "
          f"|dSSIM| {dssim:.3g}; warm call {warm['total_s']:.4f} s (decode "
          f"{warm['decode_s']:.4f}, engine {warm['engine_s']:.4f}, metrics "
          f"{warm['metric_s']:.4f})", flush=True)
    return {"triplets": res["num_triplets"], "launches": launches,
            "metrics": mm, "max_psnr_diff_db": dpsnr, "max_ssim_diff": dssim,
            "first_call": first, "warm_call": warm,
            "profiled_call_ms": profiled_ms, "device_busy_ms": busy_ms}


def eval_path(record, unet, flow) -> dict:
    """The eval path on fixtures the port writes: the U-Net engine at
    256x256 (2 videos x 10 frames, 16 triplets: 2 chunks of 8) and
    1080x1920 (1 video x 10 frames, 8 triplets: 1 chunk; then the same
    frames with rows cycling through all five PNG filters), the flow engine
    at 256x256. One ssim_eval launch per method and chunk, one refine_head
    (and for flow one sample_fused) per chunk."""
    from ai_based_frame_interpolation_torch.data.synthetic import (
        write_fixture_tree)

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, videos, hw in (("256", 2, (256, 256)),
                                 ("1080", 1, (1080, 1920))):
            t0 = time.perf_counter()
            write_fixture_tree(os.path.join(tmp, name), num_videos=videos,
                               num_frames=10, height=hw[0], width=hw[1])
            print(f"fixture {name}: {videos} x 10 frames {hw[0]}x{hw[1]} "
                  f"written in {time.perf_counter() - t0:.2f} s", flush=True)
        t0 = time.perf_counter()
        refilter_tree(os.path.join(tmp, "1080"), os.path.join(tmp, "1080_f"))
        print(f"fixture 1080 re-encoded with rows cycling through the five "
              f"filters in {time.perf_counter() - t0:.2f} s; pixels equal",
              flush=True)
        out["unet_256"] = run_eval(
            "U-Net 256x256", unet, os.path.join(tmp, "256"), (256, 256),
            dict(NO_LAUNCHES, refine_head=2, ssim_eval=4),
            os.path.join(tmp, "report_256"))
        out["unet_1080"] = run_eval(
            "U-Net 1080x1920", unet, os.path.join(tmp, "1080"), (1080, 1920),
            dict(NO_LAUNCHES, refine_head=1, ssim_eval=2),
            os.path.join(tmp, "report_1080"))
        out["unet_1080_filters"] = run_eval(
            "U-Net 1080x1920, all five filters", unet,
            os.path.join(tmp, "1080_f"), (1080, 1920),
            dict(NO_LAUNCHES, refine_head=1, ssim_eval=2),
            os.path.join(tmp, "report_1080_f"))
        out["flow_256"] = run_eval(
            "flow 256x256", flow, os.path.join(tmp, "256"), (256, 256),
            dict(NO_LAUNCHES, refine_head=2, sample_fused=2, ssim_eval=4),
            os.path.join(tmp, "report_flow_256"))
    record["eval_path"] = out
    return out


def time_ssim(smi, b, h, w) -> dict:
    """The SSIM at b x h x w gray uint8: kernel, plain and bound. ``ms``:
    CUDA events over back-to-back wrapper calls (the host's cost of each
    call included); ``device_ms``: the kernel's own device time per call
    (both of its launches, torch.profiler). No single PyTorch call
    computes skimage's SSIM, so there is no library time."""
    from ai_based_frame_interpolation_torch.ops.ssim import ssim_eval
    from ai_based_frame_interpolation_torch.ops.ssim_fused import (
        ssim_eval_auto)

    x, y = ssim_inputs(b, h, w, 1, seed=11)
    k_ms = cuda_ms(lambda: ssim_eval_auto(x, y), 20)
    parts = {}
    d_ms = kernel_device_ms(lambda: ssim_eval_auto(x, y), ("ssim",), 20,
                            parts)
    p_ms = cuda_ms(lambda: ssim_eval(x, y), 5)
    flops, byts = ssim_flops_bytes(b, h, w, 1)
    bound_ms, bound_by = bound(flops, byts, H100_F32_FLOPS)
    print(f"[{smi}] ssim_eval {b}x{h}x{w} gray uint8: kernel {k_ms:.4f} ms "
          f"(events over wrapper calls), device {_ms(d_ms)} (profiler: "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
          + f"), plain {p_ms:.4f} ms, library none (no single PyTorch call "
          f"computes skimage's SSIM), bound {bound_ms:.4f} ms ({bound_by}: "
          f"{flops / 1e9:.3f} GFLOP, {byts / 1e6:.2f} MB)", flush=True)
    return {"ms": k_ms, "device_ms": d_ms, "device_parts": parts,
            "plain_ms": p_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": bound_by, "flops": flops, "bytes": byts}


def time_png_decode(smi) -> dict:
    """Host ms to decode one 1080p gray PNG (a moving-circle fixture frame)
    with every row under one filter, per filter, and with rows cycling
    through all five: the best of 5 calls, and the share of it that is
    zlib's inflate."""
    from ai_based_frame_interpolation_torch.data.synthetic import (
        moving_circle_frames)
    from ai_based_frame_interpolation_torch.ops.png import decode_png

    img = moving_circle_frames(1, 1080, 1920)[0]
    h = img.shape[0]
    out = {}
    for name, kinds in (("none", [0] * h), ("sub", [1] * h), ("up", [2] * h),
                        ("average", [3] * h), ("paeth", [4] * h),
                        ("cycle", np.arange(h) % 5)):
        data = filtered_png(img, kinds)
        assert np.array_equal(decode_png(data), img), name
        idat = data[33 + 8:-12 - 4]             # the one IDAT chunk's body
        best = inflate = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            decode_png(data)
            t1 = time.perf_counter()
            zlib.decompress(idat)
            t2 = time.perf_counter()
            best, inflate = min(best, t1 - t0), min(inflate, t2 - t1)
        out[name] = {"ms": best * 1e3, "inflate_ms": inflate * 1e3,
                     "file_bytes": len(data)}
        print(f"[{smi}] decode_png 1080x1920 gray, filter {name}: "
              f"{best * 1e3:.3f} ms, of it inflate {inflate * 1e3:.3f} ms "
              f"({len(data)} bytes; host clock)", flush=True)
    return out


def time_engine(engine, label, smi, sizes) -> dict:
    """ms per 1080p gray 2x call, midpoints/s and output fps (originals +
    midpoints, as bench.py counts them) at each (batch, iterations)."""
    out = {}
    fn = engine._pair_fn(1, 1)
    for b, iters in sizes:
        g1, g2 = frames(b, 1080, 1920, seed=3)
        d1, d2 = engine._put(g1), engine._put(g2)
        ms = cuda_ms(lambda: fn(engine.model, d1, d2), iters, warmup=1)
        pairs_s = b / (ms / 1e3)
        out[f"{label}_b{b}"] = {"ms_per_call": ms, "midpoints_per_s": pairs_s,
                                "output_fps": 2 * pairs_s}
        print(f"[{smi}] {label} engine 1080p gray 2x b={b}: {ms:.3f} ms/call, "
              f"{pairs_s:.3f} midpoints/s, {2 * pairs_s:.3f} output fps",
              flush=True)
        del d1, d2
    return out


def time_head(smi, width, nextra, nf32, depthwise=False,
              dtype=torch.bfloat16) -> dict:
    """The head at 1x1088x1920 gray on the route ``head_route`` picks:
    kernel, plain, library (cuDNN channels_last convs in ``dtype`` with
    fused bias; timed here only) and bound. f32 runs with TF32 off (the
    same function on every side); its bound is f32 FMAs on the CUDA
    cores."""
    from ai_based_frame_interpolation_torch.ops.refine import (
        pack_head_weights, refine_head, refine_head_reference)

    b, h, w, c = 1, 1088, 1920, 1
    y, planes, params = head_inputs(b, h, w, c, nextra, width, nf32=nf32,
                                    depthwise=depthwise)
    f32 = dtype == torch.float32
    if f32:
        planes = [p.float() for p in planes]
    packed = pack_head_weights(params, dtype)
    cl = torch.channels_last
    pred = y.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    z0 = torch.cat([pred.to(dtype)] + [
        p.permute(0, 3, 1, 2).to(dtype) for p in planes],
        1).contiguous(memory_format=cl)
    lw = {n: {"weight": p["weight"].to(dtype).contiguous(
        memory_format=cl), "bias": p["bias"].to(dtype)}
        for n, p in params.items()}
    f = torch.nn.functional

    def library():
        z = f.relu(f.conv2d(z0, lw["refine1"]["weight"],
                            lw["refine1"]["bias"], padding=1))
        if depthwise:
            z = f.conv2d(z, lw["refine2_dw"]["weight"],
                         lw["refine2_dw"]["bias"], padding=1, groups=width)
            z = f.relu(f.conv2d(z, lw["refine2_pw"]["weight"],
                                lw["refine2_pw"]["bias"]))
        else:
            z = f.relu(f.conv2d(z, lw["refine2"]["weight"],
                                lw["refine2"]["bias"], padding=1))
        return pred + f.conv2d(z, lw["refine_out"]["weight"],
                               lw["refine_out"]["bias"])

    with no_tf32():
        k_ms = cuda_ms(lambda: refine_head(y, planes, params, dtype, packed),
                       10)
        p_ms = cuda_ms(lambda: refine_head_reference(y, planes, params,
                                                     dtype), 10)
        l_ms = cuda_ms(library, 10)
    nplanes = (1 + nextra) * c
    flops, f32_flops, byts = head_flops_bytes(
        b, h, w, c, nplanes, width, nextra if f32 else nf32, depthwise,
        elem=4 if f32 else 2)
    if f32:
        flops, f32_flops = 0, flops + f32_flops
    bound_ms, bound_by = bound(flops, byts, H100_BF16_FLOPS, f32_flops)
    print(f"[{smi}] refine_head{' depthwise' if depthwise else ''} "
          f"1x1088x1920 gray {nplanes} planes ({nf32} "
          f"f32) w{width} {str(dtype)[6:]}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library (cuDNN channels_last convs) {l_ms:.4f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP "
          f"bf16, {f32_flops / 1e9:.2f} GFLOP f32, {byts / 1e6:.2f} MB)",
          flush=True)
    return {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
            "f32_flops": f32_flops, "bytes": byts}


def time_dconv(smi, name, shape, dtype=torch.bfloat16) -> dict:
    """One option-core level (``CORE_LEVELS``): kernel (weights packed
    once, as the engine packs them), plain, library (cuDNN's
    channels_last conv pair with fused bias and ReLU; for the up block
    after ``F.interpolate`` and ``torch.cat``; timed here only) and bound;
    in bf16 also the fused kernel's time per weight chunk (ms / tiles per
    SM / chunks per tile, from the launch plan the kernel picks). f32: the
    direct-conv route, TF32 off on every side, bound by f32 FMAs."""
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, double_conv_reference, kernel_plan,
        pack_dconv_weights, up_double_conv_fused, up_double_conv_reference)

    b, h, w, c0, c1, mid, cout = shape
    f32 = dtype == torch.float32
    x, low, wts = dconv_inputs(*shape, seed=5)
    if f32:
        x, low = x.float(), None if low is None else low.float()
    packed = pack_dconv_weights(*wts, split=c0 if c1 else None,
                                compute_dtype=dtype)
    f = torch.nn.functional
    cl = torch.channels_last
    w1, b1, w2, b2 = (t.to(dtype) for t in wts)
    w1, w2 = (t.contiguous(memory_format=cl) for t in (w1, w2))
    xl = x.permute(0, 3, 1, 2)
    with no_tf32():
        if c1:
            lowl = low.permute(0, 3, 1, 2)
            k_ms = cuda_ms(lambda: up_double_conv_fused(
                x, low, *wts, dtype, packed), 10)
            p_ms = cuda_ms(lambda: up_double_conv_reference(x, low, *wts,
                                                            dtype), 5)

            def first():
                up = f.interpolate(lowl, scale_factor=2, mode="bilinear",
                                   align_corners=False)
                return torch.cat([xl, up], 1)
        else:
            k_ms = cuda_ms(lambda: double_conv_fused(x, *wts, dtype, packed),
                           10)
            p_ms = cuda_ms(lambda: double_conv_reference(x, *wts, dtype), 5)
            first = lambda: xl  # noqa: E731

        def library():
            z = f.relu(f.conv2d(first(), w1, b1, padding=1))
            return f.relu(f.conv2d(z, w2, b2, padding=1))

        l_ms = cuda_ms(library, 10)
    flops, byts = dconv_flops_bytes(*shape, elem=4 if f32 else 2)
    bound_ms, bound_by = bound(0 if f32 else flops, byts, H100_BF16_FLOPS,
                               flops if f32 else 0)
    out = {"ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "flops": flops,
           "bytes": byts}
    per_chunk = ""
    if not f32:
        plan = kernel_plan(c0, c1, mid, cout)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        tiles = b * -(-h // plan["th"]) * -(-w // 16)
        out.update(plan, tiles=tiles, tiles_per_sm=tiles / sms,
                   us_per_chunk=1e3 * k_ms / (tiles / sms) / plan["chunks"])
        per_chunk = (f"; {tiles} {plan['th']}x16 tiles, "
                     f"{tiles / sms:.2f} per SM, {plan['chunks']} chunks per "
                     f"tile, {'resident' if plan['resident'] else str(plan['stages']) + '-stage ring'}"
                     f": {out['us_per_chunk']:.3f} us per chunk")
    print(f"[{smi}] {'up_' if c1 else ''}double_conv {name} "
          f"{'f32 (direct) ' if f32 else ''}B={b} {h}x{w} "
          f"{c0}+{c1}->{mid}->{cout}: kernel {k_ms:.4f} ms, plain "
          f"{p_ms:.4f} ms, library (cuDNN channels_last conv pair"
          f"{', F.interpolate + cat' if c1 else ''}) {l_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}: {flops / 1e9:.2f} GFLOP, "
          f"{byts / 1e6:.2f} MB){per_chunk}", flush=True)
    return out


def summed(parts, f32=False) -> dict:
    """Timings of the calls one dispatch makes, added up (bf16 on the
    tensor cores, or ``f32`` on the CUDA cores); bound by what bounds
    their sum."""
    out = {k: sum(p[k] for p in parts) for k in
           ("ms", "plain_ms", "library_ms", "bound_ms", "flops", "bytes")}
    flops = (0, out["flops"]) if f32 else (out["flops"], 0)
    out["bound_by"] = bound(flops[0], out["bytes"], H100_BF16_FLOPS,
                            flops[1])[1]
    return out


def time_sampler(smi, b=1, max_flow=16) -> dict:
    """The sampler at b x 1088 x 1920 gray bf16 (b=1: one flow sample of a
    pair; b=8: the flow engine's b8 dispatch): kernel, plain and bound.
    ``ms``: CUDA events over back-to-back wrapper calls (the host's cost of
    each call included); ``device_ms``: the kernel's own device time per
    call (torch.profiler). No single PyTorch call computes the shifts warp
    (``F.grid_sample`` is the exact 2-D warp, with the x field read at the
    output row and no clamp), so there is no library time."""
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        sample_fused, sample_fused_reference)

    h, w, c = 1088, 1920, 1
    args = sampler_inputs(b, h, w, c, max_flow, SAMPLER_TS8[:b])
    k_ms = cuda_ms(lambda: sample_fused(*args, max_flow=max_flow), 20)
    d_ms = kernel_device_ms(lambda: sample_fused(*args, max_flow=max_flow),
                            ("sample",), 20)
    p_ms = cuda_ms(lambda: sample_fused_reference(*args, max_flow=max_flow),
                   10 if b == 1 else 3)
    flops, byts = sampler_flops_bytes(b, h, w, c)
    bound_ms, bound_by = bound(flops, byts, H100_F32_FLOPS)
    print(f"[{smi}] sample_fused {b}x{h}x{w} gray bf16 mf{max_flow}: kernel "
          f"{k_ms:.4f} ms (events over wrapper calls), device {_ms(d_ms)} "
          f"(profiler), plain {p_ms:.4f} ms, library none (no single "
          f"PyTorch call computes the shifts warp), bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.3f} GFLOP, {byts / 1e6:.2f} MB)",
          flush=True)
    return {"ms": k_ms, "device_ms": d_ms, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "flops": flops, "bytes": byts}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    smi = card()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    build(record)                              # 1.
    check_kernels(record)                      # 2.
    unet, unet_launches, unet_out = unet_path(record)    # 3.
    core, core_launches = core_path(record, unet_out)
    del unet_out
    core_path(record, None, upsample="align_corners")
    dw, dw_launches = depthwise_path(record)
    f32_path(record)
    flow, flow_launches = flow_path(record)    # 4.
    evals = eval_path(record, unet, flow)      # 6. (before 5 frees them)

    # 5. timings (CUDA events, after warm-up); the default U-Net route
    # before and after the option core
    sizes = ((8, 10), (32, 4))
    timings = time_engine(unet, "unet", smi, sizes)
    timings.update(time_engine(core, "unet_core", smi, sizes))
    timings.update(time_engine(unet, "unet_again", smi, sizes))
    del unet, core
    timings.update(time_engine(dw, "unet_dw", smi, sizes))
    del dw
    timings.update(time_engine(flow, "flow", smi, sizes))
    del flow
    timings["refine_head_w64_1088x1920"] = time_head(smi, 64, 2, 0)
    timings["refine_head_w16_1088x1920"] = time_head(smi, 16, 4, 2)
    timings["refine_head_dw_1088x1920"] = time_head(smi, 64, 2, 0,
                                                    depthwise=True)
    for name, shape in CORE_LEVELS.items():
        timings[f"dconv_{name}_b8"] = time_dconv(smi, name, shape)
    timings["double_conv_b8"] = summed(
        [timings[f"dconv_{n}_b8"] for n in ("inc", "down1", "down2")])
    timings["up_double_conv_b8"] = summed(
        [timings[f"dconv_{n}_b8"] for n in ("up3", "up4")])
    # f32 (the direct convs): the five levels at the f32 engine's b2 1080p,
    # down1 and up3 also at b8
    for name, shape in CORE_LEVELS.items():
        timings[f"dconv_{name}_b2_f32"] = time_dconv(
            smi, name, (2,) + shape[1:], torch.float32)
    timings["double_conv_b2_f32"] = summed(
        [timings[f"dconv_{n}_b2_f32"] for n in ("inc", "down1", "down2")],
        f32=True)
    timings["up_double_conv_b2_f32"] = summed(
        [timings[f"dconv_{n}_b2_f32"] for n in ("up3", "up4")], f32=True)
    for name in ("down1", "up3"):
        timings[f"dconv_{name}_b8_f32"] = time_dconv(
            smi, name, CORE_LEVELS[name], torch.float32)
    for key, args in (
            ("refine_head_w32_padded", (32, 2, 0)),
            ("refine_head_w8_padded", (8, 2, 0)),
            ("refine_head_dw16_padded", (16, 2, 0, True)),
            ("refine_head_dconv_bf16_w128", (128, 2, 0)),
            ("refine_head_dconv_bf16_w256", (256, 2, 0)),
            ("refine_head_direct_bf16_dw128", (128, 2, 0, True)),
            ("refine_head_direct_f32_w64", (64, 2, 0, False, torch.float32)),
            ("refine_head_direct_f32_dw64", (64, 2, 0, True, torch.float32)),
            ("refine_head_direct_f32_w16", (16, 4, 2, False, torch.float32))):
        timings[f"{key}_1088x1920"] = time_head(smi, *args)
    timings["sample_fused_1088x1920"] = time_sampler(smi)
    timings["sample_fused_8x1088x1920"] = time_sampler(smi, 8)
    timings["ssim_eval_8x256x256"] = time_ssim(smi, 8, 256, 256)
    timings["ssim_eval_8x1080x1920"] = time_ssim(smi, 8, 1080, 1920)
    timings["ssim_eval_1x2160x3840"] = time_ssim(smi, 1, 2160, 3840)
    timings["png_decode_1080x1920"] = time_png_decode(smi)
    for name, run in evals.items():
        split = run["warm_call"]
        busy = run["device_busy_ms"]
        print(f"[{smi}] eval {name} ({run['triplets']} triplets, unet + "
              f"linear): {split['total_s'] * 1e3:.3f} ms per call, decode "
              f"{split['decode_s'] * 1e3:.3f}, engine "
              f"{split['engine_s'] * 1e3:.3f}, metrics "
              f"{split['metric_s'] * 1e3:.3f} ms; device busy "
              f"{'not recorded' if busy is None else f'{busy:.3f} ms'} of a "
              f"profiled call of {run['profiled_call_ms']:.3f} ms",
              flush=True)
    record["timings"] = timings
    record["seconds"] = time.perf_counter() - t_start

    src = "ai_based_frame_interpolation_torch/csrc/"
    pallas = "ai_based_frame_interpolation_tpu/ops/pallas/"
    kernels = []
    ssim_errs = record["ssim_eval_errs"]
    head_errs = record["head_route_errs"]
    f32_errs = record["dconv_f32_errs"]
    record["main_routes"] = dict(MAIN_ROUTES)
    for name, cu, replaces, launches, err, tm in (
            ("refine_head_w64", "refine_head.cu", "refine_fused.py:417",
             unet_launches["refine_head"],
             record["refine_head_w64_max_abs_err"],
             "refine_head_w64_1088x1920"),
            ("refine_head_w16", "refine_head.cu", "refine_fused.py:417",
             flow_launches["refine_head"],
             record["refine_head_w16_max_abs_err"],
             "refine_head_w16_1088x1920"),
            ("sample_fused", "sample_fused.cu", "warp_fused.py:183",
             flow_launches["sample_fused"], record["sample_fused_max_abs_err"],
             "sample_fused_1088x1920"),
            ("ssim_eval_256", "ssim_eval.cu", "ssim_fused.py:63",
             evals["unet_256"]["launches"]["ssim_eval"],
             ssim_errs["8x256x256"], "ssim_eval_8x256x256"),
            ("ssim_eval_1080", "ssim_eval.cu", "ssim_fused.py:169",
             evals["unet_1080"]["launches"]["ssim_eval"],
             ssim_errs["8x1080x1920"], "ssim_eval_8x1080x1920"),
            ("double_conv", "double_conv.cu", "dconv_fused.py:164",
             core_launches["double_conv"], record["double_conv_max_abs_err"],
             "double_conv_b8"),
            ("up_double_conv", "double_conv.cu", "dconv_fused.py:411",
             core_launches["up_double_conv"],
             record["up_double_conv_max_abs_err"], "up_double_conv_b8"),
            ("refine_head_dw", "refine_head.cu", "refine_fused.py:417",
             dw_launches["refine_head"], record["refine_head_dw_max_abs_err"],
             "refine_head_dw_1088x1920"),
            # the routes beside the production instances: launches the
            # wrappers counted under each route over the main-path runs
            # (MAIN_ROUTES; 0 where no engine of the smoke takes the route)
            ("refine_head_w32_padded", "refine_head.cu", "refine_fused.py:417",
             MAIN_ROUTES["refine_head w64/w32/bfloat16"],
             head_errs["w32_bfloat16_1x1088x1920"],
             "refine_head_w32_padded_1088x1920"),
            ("refine_head_w8_padded", "refine_head.cu", "refine_fused.py:417",
             MAIN_ROUTES["refine_head w16/w8/bfloat16"],
             head_errs["w8_bfloat16_1x1088x1920"],
             "refine_head_w8_padded_1088x1920"),
            ("refine_head_dw16_padded", "refine_head.cu",
             "refine_fused.py:417", MAIN_ROUTES["refine_head dw64/dw16/bfloat16"],
             head_errs["dw16_bfloat16_1x1088x1920"],
             "refine_head_dw16_padded_1088x1920"),
            ("refine_head_dconv_bf16_w128", "double_conv.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head dconv/w128/bfloat16"],
             head_errs["w128_bfloat16_1x1088x1920"],
             "refine_head_dconv_bf16_w128_1088x1920"),
            ("refine_head_dconv_bf16_w256", "double_conv.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head dconv/w256/bfloat16"],
             head_errs["w256_bfloat16_1x1088x1920"],
             "refine_head_dconv_bf16_w256_1088x1920"),
            ("refine_head_direct_bf16_dw128", "conv_direct.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head direct/dw128/bfloat16"],
             head_errs["dw128_bfloat16_1x1088x1920"],
             "refine_head_direct_bf16_dw128_1088x1920"),
            ("refine_head_direct_f32_w64", "conv_direct.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head direct/w64/float32"],
             head_errs["w64_float32_1x1088x1920"],
             "refine_head_direct_f32_w64_1088x1920"),
            ("refine_head_direct_f32_dw64", "conv_direct.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head direct/dw64/float32"],
             head_errs["dw64_float32_1x1088x1920"],
             "refine_head_direct_f32_dw64_1088x1920"),
            ("refine_head_direct_f32_w16", "conv_direct.cu",
             "refine_fused.py:417",
             MAIN_ROUTES["refine_head direct/w16/float32"],
             head_errs["w16_float32_1x1088x1920"],
             "refine_head_direct_f32_w16_1088x1920"),
            ("double_conv_direct_f32", "conv_direct.cu", "dconv_fused.py:164",
             MAIN_ROUTES["double_conv direct"],
             max(e for k, e in f32_errs.items() if "up" not in k),
             "double_conv_b2_f32"),
            ("up_double_conv_direct_f32", "conv_direct.cu",
             "dconv_fused.py:411", MAIN_ROUTES["up_double_conv direct"],
             max(e for k, e in f32_errs.items() if "up" in k),
             "up_double_conv_b2_f32")):
        t = timings[tm]
        kernels.append({"name": name, "route": "cuda", "source": src + cu,
                        "replaces": pallas + replaces, "launches": launches,
                        "max_abs_err": err, "ms": t["ms"],
                        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                        "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    print("record " + json.dumps(record), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
