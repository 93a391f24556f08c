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
   launches, the upsample composed; that engine built on the default route
   and ``core_impl`` assigned after its run, which packs the core) against
   its own default route, and with the depthwise head
   (``refine_depthwise=True``), then the f32 production engine
   (``compute_dtype=torch.float32``) at b2 1080p on the default route
   (the head on the direct convs: 2 + 1 launches) and on the option core
   (10 more direct-conv launches), TF32 off for the phase;
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
   arrays, and the JSON, CSV and markdown reports written and read back;
7. drives the video paths (also before 5), on 17 seeded 1080p gray
   frames: the U-Net engine of phase 3 through ``interpolate_video_frames``
   at 2x and 4x (two batches of 8 pairs; 1 and 3 ``refine_head`` launches a
   batch), the flow engine of phase 4 through ``retime_video_frames`` at
   rate 2.5 over 9 frames (one ``sample_fused`` and one w16 head launch per
   padded time), and the tower (``TOWER_PROD``: slim decoder, s2d 4, w64
   head, base 64, depth 4, random weights from a seed) through its
   shared-encode stream at 2x; every original bit for bit, every
   in-between within 1 LSB of the engine's pair calls on the same pairs
   (``interpolate_batch``; at 4x the 4x pair function on the stream's
   batches of 8, and ``generate_intermediate_frames`` one pair a call
   recorded beside it; ``interpolate_at``), the launch and route counts
   asserted; then each stream once warm over 65 frames in host memory
   (host clock over the whole generator: output fps), once with its host
   steps timed, and once under torch.profiler (the device's busy share),
   beside the bare pair functions at b8 (the U-Net 2x's from phase 5),
   printed after phase 5 with the ratio;
8. drives the training path (``train/loop.py``) on a scene tree it writes
   (``write_scene_tree``: 6 gray 256x256 clips of 16 frames, 84 triplets,
   split 67 train / 17 val): the full-width production U-Net (bf16
   compute, f32 weights, batch 8, random weights from a seed) takes five
   ``train_step``s on one batch (every parameter's gradient finite and
   somewhere non-zero after the first, the loss lower after the fifth, no
   kernel launched: every count 0); every kernel wrapper on the card
   raises for grad-requiring inputs or weights; ``train_model`` runs 2
   epochs with EMA, validation and checkpoints, and its validation phases
   launch the w64 head and the SSIM kernel once per val batch and nothing
   else (counted); the validation predictions are held within 1 LSB of
   the same unfolded model composed with the plain head on the current
   EMA weights, and their SSIM within ``SSIM_BOUND`` of the plain metric;
   ``latest`` restores into a fresh state bit for bit (parameters,
   buffers, EMA, Adam's state, step) and the next step's loss agrees
   within 1e-3 relative; ``best``'s EMA export (``save_variables``) serves
   through ``InterpolationEngine.from_checkpoint`` within 1 LSB of the
   plain composition on the w64 head kernel; the flow production config
   takes two steps with the smoothness, photometric and census losses on
   (gradients reach every weight, no kernel) and one validation (one
   sampler, one w16 head and one SSIM launch). Then it times a warm
   ``train_step`` of each and the U-Net's ``eval_step`` (CUDA events), the
   peak device memory of the U-Net's steps and the device's busy share of
   one profiled step, printed on a ``train`` line beside the card's name
   and power limit.
9. serves HTTP (``serve/server.py`` over the batcher; before 5 frees the
   engines): after ``warmup``, a ``Server`` on 127.0.0.1 over phase 3's
   production U-Net engine at 256x256 and one over phase 4's flow engine,
   in background threads, driven by real requests (``http.client``) with
   PNG frames written by ``ops/png.py``: ``GET /``, ``/health``,
   ``/model-info``; ``/interpolate-frames`` at 1 and 3 in-betweens, each
   frame decoded and held against ``generate_intermediate_frames`` on the
   same frames (1 LSB; 2 for bisected ones); 8 concurrent requests that
   the batcher fuses (at least one dispatch of more than one request); a
   300x200 upload the server resizes; the flow server at ``times``
   0.25,0.6 against ``interpolate_at``; ``/interpolate`` and
   ``/evaluate-interpolation`` (answered for real where OpenCV is
   installed, and with ``cv2`` hidden: 500 naming OpenCV while ``/health``
   still answers with the requests counted); ``make_fastapi_app``'s routes
   where fastapi is installed. Every group has its launch counts asserted
   (the w64 head once per U-Net forward of a dispatch, the sampler and the
   w16 head once per flow time). Then, host clock after warmup: the
   latency of 60 sequential requests at 1 and at 3 in-betweens (p50,
   p95), at 1 also with TCP_NODELAY, in-process on this thread and on a
   new thread a call, the engine alone on one thread and on a new thread
   a call, a raw loopback round trip of the same bytes; requests/s of 8
   concurrent clients, one profiled request's device-busy share, and the
   host PNG decode and encode of a 256x256 frame, printed on a ``serve``
   line beside the card's name and power limit;
10. runs the command line in this process (``cli.main``, ``--device`` at
   its default): ``dataset`` (2 clips at 256x256), ``info`` on phase 8's
   export (its checkpoint directory), ``infer`` on that export (one w64
   head launch; the PNG within 1 LSB of the export's engine), ``convert``
   of a reference-config model (``ModelConfig()``, random weights from a
   seed) ``.pth`` -> export directory -> ``.pth`` bit for bit and
   ``infer`` on that ``.pth``; then ``python3 -m
   ai_based_frame_interpolation_torch serve`` as a subprocess on port 0:
   its "serving on" line read, one ``/interpolate-frames`` and one
   ``/health`` sent, SIGTERM, exit code 0.
11. drives the model options (after 5 frees the engines), on 8 gray
   1080p pairs: the flow production config with ``flow_bidir``,
   ``flow_cascade=1``, ``flow_cascade=2`` with ``flow_bidir``, and the
   ``pyramid``, ``gather4`` and ``patch`` warps (random weights from a
   seed, the cascade's out convs drawn too), each at 2x (b8) and through
   ``interpolate_at`` at 0.25 and 0.6, within 1 LSB of the same modules
   composed with the plain head (and the plain sampler where the config
   takes it), one ``refine_head`` launch per sample and one
   ``sample_fused`` launch per sample for the single-field cascade only,
   ``patch`` bit for bit ``gather4``; then the production U-Net with
   ``core_pack`` 2 and 4 (within 1 LSB of the unpacked engine, 1 head
   launch and no double conv a dispatch, one packed dispatch counted; a
   b6 batch at g=4 unpacked, bit for bit) and with ``UP_POLYPHASE`` (within
   1 LSB of the lerp path); each engine timed at b8 (``time_engine``, 5
   calls) and printed beside phase 5's production flow engine and the
   card's name and power limit.

12. data parallel on the one card (after 11): a process group of one
   rank on NCCL through the distributed code (the production U-Net's
   train step at 256x256 b8 bit for bit the step without a mesh, under
   deterministic algorithms for the comparison; its ``eval_step`` with
   one head and one SSIM launch; both steps timed in turns, samples/s);
   two ranks spawned on the one card over gloo with CUDA tensors, each
   step (plain, ``grad_accum=2`` with EMA) on the global b8 against the
   step in one process: computing in f64, loss and BatchNorm statistics
   within 1e-6 relative and every parameter's gradient within 1e-5 of
   its largest; computing in f32, loss and statistics within 1e-6 and
   the gradients' relative L2 error against f64 within 3x the
   one-process f32 steps' (cuDNN's convs and PyTorch's own), each
   parameter's read; both ranks holding the same state); ``cli train
   --num-devices`` one more
   than the visible cards refused with JAX's error; the production
   U-Net and flow engines with two replicas on cuda:0 within 1 LSB of
   the unmeshed engines at b8 1080p, each replica launching the head
   (and the sampler) once, both timed; then the height split on cuda:0
   (a mesh of two parts, b1): the production U-Net and flow engines
   within 1 LSB of the unmeshed ones at 1080x1920 and 2160x3840 and on a
   4-frame stream whose 1-pair tail splits by height, the head (and the
   sampler) launched once per row window (the flow config's 1080p frame
   is one window: its halo would make a window the whole frame), the
   windows' rows computed printed beside the rows kept, each engine
   timed at b1 beside the unmeshed one; and the U-Net with ``core_impl="pallas"`` at 2160x3840
   (3 double-conv, 2 up-block and 1 head launch per window).

Besides each kernel's launch counter, the wrappers that pick a route
(``refine_head``, ``double_conv_fused``, ``up_double_conv_fused``) count
their launches under it (``.routes``); the kernels line reads those counts
over the main-path runs of phases 3, 4 and 6-12.

Any failure raises and exits non-zero. It prints the kernel record as one
JSON line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
after a ``record {...}`` line with every number it measured.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
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

# what cuBLAS needs for deterministic algorithms (phase 12), read when its
# first handle is made
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak, FLOP/s
H100_HBM_BYTES = 3.35e12       # HBM3 bandwidth, B/s
FLOAT_BOUND = 0.032            # 2 bf16 ulp at |x| < 4 (see check_kernel)
PROD = dict(space_to_depth=4, residual=True, refine_width=64,
            upsample="half_pixel")
FLOW_PROD = dict(arch="flow", base_width=32, flow_scale=4, refine_width=16,
                 warp_impl="shifts", max_flow=16)
# bench.py's defaults with --arch tower and the README's streaming option
TOWER_PROD = dict(arch="tower", space_to_depth=4, residual=True,
                  refine_width=64, upsample="half_pixel", slim_decoder=True)
VIDEO_FRAMES = 17              # checked streams: 16 pairs, two batches of 8
VIDEO_TIMED_FRAMES = 65        # the timed streams: 64 pairs, eight batches
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
    port modules with the plain sampler and head, for the check only (for
    a config the sampler does not compute, the model's own stock PyTorch
    warps and blend, which is what the engine runs there)."""
    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head_reference)
    from ai_based_frame_interpolation_torch.ops.resize import crop_to
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        config_eligible, sample_fused_reference)

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
            if config_eligible(engine.cfg):
                out, g0, g1 = sample_fused_reference(
                    nhwc(x1), nhwc(x2), nhwc(flow), nhwc(mask), tt,
                    engine.cfg.max_flow)
            else:       # the bidirectional field, the other warps: no kernel
                out, g0, g1 = (nhwc(p) for p in model.sample_parts(
                    x1, x2, flow, mask, tt))
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


# every route's launches over the main-path runs (phases 3, 4, 6-10), each
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
    batcher.close()
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
    per dispatch; the align-corners one 5 double_conv on the concat. That
    engine is built on the default route, and ``core_impl`` is assigned
    after its default-route run, as the JAX CLI assigns it: the setter
    packs the core."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    cfg = ModelConfig(**dict(PROD, upsample=upsample))
    f1, f2 = frames(8, 1080, 1920, seed=1)
    if xla_out is None:
        engine = InterpolationEngine.random_init(cfg, seed=0)
        xla_out = engine.interpolate_batch(f1, f2)
        assert engine.model.packed_core is None
        engine.core_impl = "pallas"
        assert engine.model.packed_core is not None
        print(f"U-Net option core ({upsample}): core_impl assigned after "
              "construction; the core packed", flush=True)
    else:
        engine = InterpolationEngine.random_init(cfg, seed=0,
                                                 core_impl="pallas")
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


# phase 11: the flow production config with each model option, and the
# production U-Net with core_pack and UP_POLYPHASE
OPTION_FLOWS = {
    "bidir": dict(flow_bidir=True),
    "cascade1": dict(flow_cascade=1),          # single field, shifts
    "bidir_cascade2": dict(flow_bidir=True, flow_cascade=2),
    "pyramid": dict(warp_impl="pyramid"),
    "gather4": dict(warp_impl="gather4"),
    "patch": dict(warp_impl="patch"),
}
OPTION_TIMES = [0.25, 0.6]
OPTION_TIMED = ((8, 5),)       # one checked call, then 1 + 5 timed ones


def drawn_cascade(model, seed) -> None:
    """Draw each cascade stage's out conv (normal, std 0.01) from ``seed``:
    ``random_init`` starts it at zero, as the Flax model does, which would
    leave the field unchanged by the stages in the checks and timings."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in model.named_modules():
            if re.fullmatch(r"cascade\d+_out", name):
                m.weight.copy_(0.01 * torch.randn(m.weight.shape,
                                                  generator=gen))


def max_diff(got, want) -> tuple:
    """(max uint8 difference, share of values that differ)."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(d.max()), float((d > 0).mean())


def option_flow(name, extra, f1, f2, smi) -> tuple:
    """One flow option engine: 2x at b8 and ``interpolate_at`` at
    ``OPTION_TIMES`` on one pair, each with the counts set to 0 just before
    and read just after, within 1 LSB of the plain composition; then
    timed. Returns (its record, the 2x and interpolate_at outputs)."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        config_eligible)

    cfg = ModelConfig(**dict(FLOW_PROD, **extra))
    engine = InterpolationEngine.random_init(cfg, seed=0)
    drawn_cascade(engine.model, seed=5)
    fused = int(config_eligible(cfg))
    rec = {"sampler_kernel": bool(fused)}
    reset_counts()
    out2x = engine.interpolate_batch(f1, f2)
    rec["launches_2x"] = main_counts()
    reset_counts()
    out_at = np.stack(engine.interpolate_at(f1[0], f2[0], OPTION_TIMES))
    rec["launches_at"] = main_counts()
    for key, k in (("launches_2x", 1), ("launches_at", len(OPTION_TIMES))):
        want = dict(NO_LAUNCHES, refine_head=k, sample_fused=k * fused)
        assert rec[key] == want, \
            f"flow option {name}: {key} {rec[key]}, not {want}"
    assert out2x.shape == f1.shape and out2x.dtype == np.uint8
    assert out_at.shape == (len(OPTION_TIMES), *f1.shape[1:])
    want2x = reference_flow(engine, f1, f2, [0.5])[:, 0].cpu().numpy()
    want_at = reference_flow(engine, f1[:1], f2[:1], OPTION_TIMES)[0]
    rec["max_uint8_diff_2x"], rec["differing_2x"] = max_diff(out2x, want2x)
    rec["max_uint8_diff_at"], rec["differing_at"] = max_diff(
        out_at, want_at.cpu().numpy())
    print(f"flow option {name}: 2x b=8 1080x1920 launches "
          f"{rec['launches_2x']}, interpolate_at {OPTION_TIMES} launches "
          f"{rec['launches_at']}; vs plain sampler and head: max uint8 diff "
          f"{rec['max_uint8_diff_2x']} (differing "
          f"{rec['differing_2x']:.6g}) and {rec['max_uint8_diff_at']}; mean "
          f"output {float(out2x.mean()):.3f}", flush=True)
    assert rec["max_uint8_diff_2x"] <= 1 and rec["max_uint8_diff_at"] <= 1
    rec["timing"] = time_engine(engine, f"flow_{name}", smi,
                                OPTION_TIMED)[f"flow_{name}_b8"]
    return rec, (out2x, out_at)


def unet_options(f1, f2, smi) -> dict:
    """The production U-Net with ``core_pack`` 2 and 4 and with
    ``UP_POLYPHASE``, each within 1 LSB of the unpacked lerp engine on the
    same weights and frames, 1 head launch and no double conv a dispatch;
    a b6 batch at g=4 runs unpacked (its packed dispatches counted); each
    timed beside the unpacked engine."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.models import unet as unet_mod

    one_head = dict(NO_LAUNCHES, refine_head=1)
    base = InterpolationEngine.random_init(ModelConfig(**PROD), seed=0)
    reset_counts()
    ref = base.interpolate_batch(f1, f2)
    out = {"default": {"launches": main_counts()}}
    assert out["default"]["launches"] == one_head
    out["default"]["timing"] = time_engine(base, "unet_default", smi,
                                           OPTION_TIMED)["unet_default_b8"]
    for g in (2, 4):
        engine = InterpolationEngine.random_init(ModelConfig(**PROD), seed=0,
                                                 core_pack=g)
        packed = []
        build_packed = engine._packed_core

        def counted(model, build=build_packed, calls=packed):
            calls.append(1)
            return build(model)

        engine._packed_core = counted
        reset_counts()
        got = engine.interpolate_batch(f1, f2)
        rec = {"launches": main_counts(), "packed_dispatches": len(packed)}
        rec["max_uint8_diff"], rec["differing"] = max_diff(got, ref)
        print(f"U-Net core_pack={g}: b=8 1080x1920 launches "
              f"{rec['launches']}, packed dispatches "
              f"{rec['packed_dispatches']}; vs unpacked: max uint8 diff "
              f"{rec['max_uint8_diff']}, differing {rec['differing']:.6g}",
              flush=True)
        assert rec["launches"] == one_head and len(packed) == 1
        assert rec["max_uint8_diff"] <= 1
        if g == 4:
            reset_counts()
            got6 = engine.interpolate_batch(f1[:6], f2[:6])
            rec["b6"] = {"launches": main_counts(),
                         "packed_dispatches": len(packed) - 1}
            assert rec["b6"] == {"launches": one_head,
                                 "packed_dispatches": 0}
            assert np.array_equal(got6, base.interpolate_batch(f1[:6],
                                                               f2[:6]))
            print(f"U-Net core_pack=4 at b=6: unpacked, launches "
                  f"{rec['b6']['launches']}, bit for bit the unpacked "
                  "engine", flush=True)
        rec["timing"] = time_engine(engine, f"unet_pack{g}", smi,
                                    OPTION_TIMED)[f"unet_pack{g}_b8"]
        out[f"core_pack_{g}"] = rec
        del engine
    try:
        unet_mod.UP_POLYPHASE = True
        reset_counts()
        got = base.interpolate_batch(f1, f2)
        rec = {"launches": main_counts()}
        rec["max_uint8_diff"], rec["differing"] = max_diff(got, ref)
        print(f"U-Net UP_POLYPHASE: b=8 1080x1920 launches "
              f"{rec['launches']}; vs the lerp path: max uint8 diff "
              f"{rec['max_uint8_diff']}, differing {rec['differing']:.6g}",
              flush=True)
        assert rec["launches"] == one_head and rec["max_uint8_diff"] <= 1
        rec["timing"] = time_engine(base, "unet_polyphase", smi,
                                    OPTION_TIMED)["unet_polyphase_b8"]
    finally:
        unet_mod.UP_POLYPHASE = False
    out["up_polyphase"] = rec
    return out


def options_path(record, smi, flow_fps) -> dict:
    """Phase 11: the flow production config with each of ``OPTION_FLOWS``
    (``option_flow``; ``patch`` bit for bit ``gather4``), then the U-Net
    options (``unet_options``); every output fps printed beside the card
    and phase 5's production flow engine (``flow_fps``)."""
    f1, f2 = frames(8, 1080, 1920, seed=1)
    out = {"flow": {}, "launches": collections.Counter()}
    outputs = {}
    for name, extra in OPTION_FLOWS.items():
        rec, result = option_flow(name, extra, f1, f2, smi)
        out["flow"][name] = rec
        for key in ("launches_2x", "launches_at"):
            out["launches"]["refine_head_w16"] += rec[key]["refine_head"]
            out["launches"]["sample_fused"] += rec[key]["sample_fused"]
        if name in ("gather4", "patch"):
            outputs[name] = result
    assert all(np.array_equal(a, b) for a, b in zip(outputs["patch"],
                                                    outputs["gather4"])), \
        "the patch warp is not bit for bit the gather4 warp"
    print("flow option patch: bit for bit gather4 (2x and interpolate_at)",
          flush=True)
    out["patch_equals_gather4"] = True
    del outputs
    out["unet"] = unet_options(f1, f2, smi)
    for rec in out["unet"].values():
        out["launches"]["refine_head_w64"] += rec["launches"]["refine_head"]
        if "b6" in rec:
            out["launches"]["refine_head_w64"] += \
                rec["b6"]["launches"]["refine_head"]
    flows, unets = (", ".join(f"{n} {r['timing']['output_fps']:.3f}"
                              for n, r in out[k].items())
                    for k in ("flow", "unet"))
    print(f"[{smi}] model options, output fps at b8 1080p gray 2x: flow "
          f"production (phase 5) {flow_fps:.3f}; {flows}. U-Net {unets}",
          flush=True)
    out["launches"] = dict(out["launches"])
    record["options"] = out
    return out


# phase 12: data parallel on the one card, at phase 8's size
DP_STEPS = {"plain": {}, "grad_accum_and_ema": dict(grad_accum=2,
                                                    ema_decay=0.9)}
DP_REL_BOUND = 1e-6            # the loss and the BatchNorm statistics
# computing in f64 (parameters, gradients and the loss stay f32), the two
# ranks' step is held to the one-process step at the CPU tests' bound:
# each parameter's gradient within DP_F64_BOUND of its largest value
DP_F64_BOUND = 1e-5
# computing in f32 (TF32 off), the whole gradient's relative L2 error
# against the f64 one-process step within DP_GRAD_NOISE times the
# one-process f32 steps' own (cuDNN's convs and PyTorch's), floor 1e-5.
# Per parameter f32 is only read: at the ranks' per-call batch cuDNN's
# f32 algorithm moves a deep conv's gradient ten times further from f64
# than at the one-process batch (PERF.md, PR 15)
DP_GRAD_NOISE = 3.0
DP_GRAD_FLOOR = 1e-5
# a fault the two-rank check must catch (scripts/torch_dp_train.py
# --fault): the BatchNorm sums' backward without its all-reduce, each rank
# then taking only its own items' share of the global statistics' gradient
DP_FAULTS = ("local_batchnorm_backward",)


def dp_batch(seed) -> dict:
    """A global b8 256x256 uint8 batch: two ``frames`` and their mean."""
    f0, f1 = frames(TRAIN_BATCH, TRAIN_HW, TRAIN_HW, seed)
    gt = ((f0.astype(np.uint16) + f1) // 2).astype(np.uint8)
    return {"f0": f0, "f1": f1, "gt": gt}


def dp_state(weights, kw, dtype):
    """A train state of the production U-Net on ``weights`` computing in
    ``dtype``, with ``kw``'s EMA."""
    from ai_based_frame_interpolation_torch.config import (
        ModelConfig, TrainConfig)
    from ai_based_frame_interpolation_torch.models import build_model
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state)

    model = build_model(ModelConfig(**PROD), dtype)
    model.load_state_dict(weights)
    return create_train_state(model, None, TrainConfig(
        batch_size=TRAIN_BATCH, learning_rate=1e-4,
        ema_decay=kw.get("ema_decay", 0.0)))


def dp_step(state, batch, kw, mesh=None):
    from ai_based_frame_interpolation_torch.config import LossConfig
    from ai_based_frame_interpolation_torch.train.loop import train_step

    return train_step(state, batch, LossConfig(),
                      ema_decay=kw.get("ema_decay", 0.0),
                      grad_accum=kw.get("grad_accum", 1), mesh=mesh)


def dp_record(state, loss) -> dict:
    """A step's loss, gradients, parameters, statistics and EMA, on the
    host."""
    model = state.model
    return {"loss": float(loss),
            "grads": {n: p.grad.cpu() for n, p in model.named_parameters()},
            "params": {n: p.detach().cpu() for n, p in
                       model.named_parameters()},
            "stats": {n: b.cpu() for n, b in model.named_buffers()
                      if "running" in n},
            "ema": {n: e.cpu() for n, e in (state.ema_params or {}).items()}}


def dp_worker(rank, root, port, fault=None) -> None:
    """Rank ``rank`` of two on the one card, over gloo with CUDA tensors:
    each ``DP_STEPS`` step on its part of the global batch, computing in
    f32 (TF32 off) and in f64, with ``fault`` (one of ``DP_FAULTS``)
    injected if given; its records to ``<root>/rank<rank>.pt``."""
    import torch.distributed as dist

    from ai_based_frame_interpolation_torch.parallel import (
        make_mesh, shard_items)
    from ai_based_frame_interpolation_torch.parallel.sharding import (
        replicas_agree)

    if fault == "local_batchnorm_backward":
        from ai_based_frame_interpolation_torch.models import unet

        unet._SumOverRanks.backward = staticmethod(lambda ctx, g: g)
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}: one of {DP_FAULTS}")
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    try:
        inputs = torch.load(os.path.join(root, "inputs.pt"))
        mesh = make_mesh(devices=["cuda:0", "cuda:0"])
        out = {}
        with no_tf32():
            for name, kw in DP_STEPS.items():
                idx, _ = shard_items(TRAIN_BATCH, mesh,
                                     kw.get("grad_accum", 1))
                part = {k: v[torch.from_numpy(idx)].cuda()
                        for k, v in inputs["batch"].items()}
                for dtype, cudnn in ((torch.float32, True),
                                     (torch.float64, True),
                                     (torch.float32, False)):
                    torch.backends.cudnn.enabled = cudnn
                    try:
                        state = dp_state(inputs["weights"], kw, dtype)
                        state, loss = dp_step(state, part, kw, mesh)
                    finally:
                        torch.backends.cudnn.enabled = True
                    rec = dp_record(state, loss)
                    rec["agree"] = replicas_agree(
                        list(state.model.state_dict().values())
                        + list((state.ema_params or {}).values()), mesh)
                    out[name, str(dtype) + ("" if cudnn else " native")] \
                        = rec
        torch.save(out, os.path.join(root, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def rel_err(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def l2_err(got: dict, want: dict) -> float:
    """The relative L2 error of a dict of tensors taken as one vector."""
    d = torch.cat([(got[k] - want[k]).reshape(-1) for k in want])
    return float(d.norm() / torch.cat([w.reshape(-1)
                                       for w in want.values()]).norm())


def dp_one_process(weights, batch) -> dict:
    """Per ``DP_STEPS`` step, the one-process step on the global batch
    computing in f64 (``truth``) and in f32 (TF32 off) with cuDNN's convs
    (``single``) and with PyTorch's own (``native``)."""
    out = {}
    with no_tf32():
        dev = {k: v.cuda() for k, v in batch.items()}
        for name, kw in DP_STEPS.items():
            def step(dtype=torch.float32):
                return dp_record(*dp_step(dp_state(weights, kw, dtype), dev,
                                          kw))
            rec = {"truth": step(torch.float64), "single": step()}
            torch.backends.cudnn.enabled = False
            try:
                rec["native"] = step()
            finally:
                torch.backends.cudnn.enabled = True
            out[name] = rec
    return out


def leaf_errs(got: dict, want: dict) -> dict:
    """Each gradient's largest error against its largest value."""
    return {k: rel_err(got["grads"][k], w) for k, w in want["grads"].items()}


def dp_two_ranks(smi, fault=None) -> dict:
    """Two ranks on the one card over gloo against the one-process step on
    the same global b8 (``dp_one_process``): computing in f64, the loss and
    the BatchNorm running statistics within ``DP_REL_BOUND`` relative and
    each parameter's gradient within ``DP_F64_BOUND`` of its largest;
    computing in f32, the loss and statistics within ``DP_REL_BOUND`` and
    the whole gradient within ``DP_GRAD_NOISE`` (each parameter read, and
    read again with cuDNN off in the ranks); every rank holding rank 0's
    state bit for bit. ``fault`` (``DP_FAULTS``) is injected into the
    ranks. Returns the readings, each step's ``ok`` among them; the
    caller asserts."""
    import torch.multiprocessing as mp

    from ai_based_frame_interpolation_torch.parallel import free_port

    weights = train_model_of(PROD, 7).state_dict()
    batch = {k: torch.from_numpy(v) for k, v in dp_batch(61).items()}
    out = {}
    with tempfile.TemporaryDirectory() as root:
        torch.save({"weights": weights, "batch": batch},
                   os.path.join(root, "inputs.pt"))
        t0 = time.perf_counter()
        ranks = mp.spawn(dp_worker, args=(root, free_port(), fault),
                         nprocs=2, join=False)
        ref = dp_one_process(weights, batch)
        while not ranks.join():
            pass
        out["ranks_s"] = time.perf_counter() - t0
        got = [torch.load(os.path.join(root, f"rank{r}.pt")) for r in (0, 1)]
    f32, f64 = str(torch.float32), str(torch.float64)
    for name in DP_STEPS:
        truth, w = ref[name]["truth"], ref[name]["single"]
        g64, g32 = got[0][name, f64], got[0][name, f32]
        e64 = leaf_errs(g64, truth)
        leaf64 = max(e64, key=e64.get)
        loss64 = abs(g64["loss"] - truth["loss"]) / abs(truth["loss"])
        stats64 = max(rel_err(g64["stats"][k], truth["stats"][k])
                      for k in truth["stats"])
        # f32: errors against the f64 step, beside the one-process f32
        # steps' own
        own = {o: leaf_errs(ref[name][o], truth) for o in ("single",
                                                           "native")}
        e32 = leaf_errs(g32, truth)
        e_nat = leaf_errs(got[0][name, f32 + " native"], truth)
        ratio = {k: e32[k] / max(own["single"][k], own["native"][k],
                                 DP_GRAD_FLOOR) for k in e32}
        leaf = max(ratio, key=ratio.get)
        grad = l2_err(g32["grads"], truth["grads"])
        noise = max(max(l2_err(ref[name][o]["grads"], truth["grads"])
                        for o in own), DP_GRAD_FLOOR)
        loss = abs(g32["loss"] - w["loss"]) / abs(w["loss"])
        stats = max(rel_err(g32["stats"][k], w["stats"][k])
                    for k in w["stats"])
        agree = all(r[k]["agree"] and r[k]["loss"] == got[0][k]["loss"]
                    for r in got for k in r if k[0] == name)
        ok = (loss64 <= DP_REL_BOUND and stats64 <= DP_REL_BOUND
              and e64[leaf64] <= DP_F64_BOUND and loss <= DP_REL_BOUND
              and stats <= DP_REL_BOUND and grad <= DP_GRAD_NOISE * noise
              and agree)
        out[name] = {
            "f64_leaf_worst_err": e64[leaf64], "f64_leaf_worst": leaf64,
            "f64_loss_rel_err": loss64, "f64_stats_rel_err": stats64,
            "f32_grad_l2_vs_f64": grad, "f32_grad_l2_one_process": noise,
            "f32_loss_rel_err": loss, "f32_stats_rel_err": stats,
            "f32_leaf_worst_ratio": ratio[leaf], "f32_leaf_worst": leaf,
            "f32_leaf_worst_err": e32[leaf],
            "f32_leaf_worst_one_process": {o: v[leaf]
                                           for o, v in own.items()},
            "f32_leaf_worst_ranks_native": e_nat[leaf],
            "ranks_agree": agree, "loss": g32["loss"], "ok": ok,
            "fault": fault}
        tag = f" FAULT {fault}" if fault else ""
        print(f"[{smi}] data parallel {name}{tag}: 2 ranks on cuda:0 over "
              f"gloo vs one process at b{TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW}."
              f" f64: loss {loss64:.3g}, BatchNorm statistics {stats64:.3g} "
              f"relative, gradients at most {e64[leaf64]:.3g} of their "
              f"largest ({leaf64}). f32 (TF32 off): loss {loss:.3g}, "
              f"statistics {stats:.3g}; gradients' L2 against f64 "
              f"{grad:.3g} (one process up to {noise:.3g}); per parameter "
              f"against f64, worst {ratio[leaf]:.3g}x the one process's "
              f"({leaf}: {e32[leaf]:.3g}; one process "
              f"{own['single'][leaf]:.3g} cuDNN, {own['native'][leaf]:.3g} "
              f"PyTorch's convs; the ranks with PyTorch's convs "
              f"{e_nat[leaf]:.3g}); ranks agree {agree}; ok {ok}",
              flush=True)
    return out


def same_state(a, b) -> bool:
    sa, sb = a.model.state_dict(), b.model.state_dict()
    return all(torch.equal(sa[k], sb[k]) for k in sa) and all(
        torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)


def dp_world_one(smi) -> dict:
    """A process group of one rank on NCCL through the distributed code:
    the production U-Net's step (bf16, phase 8's config) bit for bit the
    step without a mesh (deterministic algorithms for the comparison: the
    step is not bit for bit itself without them; cuBLAS's workspace set
    for them at import), its ``eval_step`` on the kernels, and both steps
    timed in turns."""
    import torch.distributed as dist

    from ai_based_frame_interpolation_torch.config import TrainConfig
    from ai_based_frame_interpolation_torch.parallel import (
        free_port, make_mesh)
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state, eval_step, train_step)

    tcfg = TrainConfig(batch_size=TRAIN_BATCH, learning_rate=1e-4,
                       ema_decay=0.9)
    dev = {k: torch.from_numpy(v).cuda() for k, v in dp_batch(62).items()}
    out = {}
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        assert mesh.grouped and mesh.size == 1, mesh
        saved = (torch.backends.cudnn.deterministic,
                 torch.backends.cudnn.benchmark,
                 torch.are_deterministic_algorithms_enabled())
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(True)
        try:
            states = [create_train_state(train_model_of(PROD, 6), None, tcfg)
                      for _ in range(3)]
            losses = []
            reset_counts()
            for state, m in zip(states, (None, None, mesh)):
                _, loss = train_step(state, dev, tcfg.loss,
                                     ema_decay=tcfg.ema_decay, mesh=m)
                losses.append(loss)
            assert counts() == NO_LAUNCHES and not route_counts()
        finally:
            (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark) = saved[:2]
            torch.use_deterministic_algorithms(saved[2])
        repeat = same_state(states[0], states[1])
        bit = same_state(states[0], states[2]) and \
            torch.equal(losses[0], losses[2])
        print(f"[{smi}] data parallel, world size 1 on NCCL: the "
              f"distributed step bit for bit the plain one {bit} (the plain "
              f"step bit for bit itself {repeat}); loss {float(losses[2]):.6f}",
              flush=True)
        assert repeat and bit
        out["bit_for_bit"] = bit
        reset_counts()
        got = eval_step(states[2], dev, tcfg.loss, use_ema=True, mesh=mesh)
        launches = main_counts()
        want = eval_step(states[0], dev, tcfg.loss, use_ema=True)
        diff = {k: abs(float(got[k]) - float(want[k])) for k in got}
        print(f"[{smi}] data parallel, world size 1: eval_step launches "
              f"{launches}; vs the plain eval_step {diff}", flush=True)
        assert launches == dict(NO_LAUNCHES, refine_head=1, ssim_eval=1), \
            launches
        assert diff["loss"] <= 1e-6 and diff["ssim"] <= 1e-6 and \
            diff["psnr"] <= PSNR_BOUND_DB, diff
        out["eval_launches"] = launches
        out["eval_diff_vs_plain"] = diff
        times = {}
        for label, state, m in (("plain", states[0], None),
                                ("world1", states[2], mesh),
                                ("world1_again", states[2], mesh),
                                ("plain_again", states[0], None)):
            ms = cuda_ms(lambda: train_step(state, dev, tcfg.loss,
                                            ema_decay=tcfg.ema_decay,
                                            mesh=m), TRAIN_TIMED_STEPS)
            times[label] = {"ms": ms, "samples_per_s": TRAIN_BATCH * 1e3 / ms}
        out["times"] = times
        print(f"[{smi}] data parallel, world size 1: train step b"
              f"{TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} bf16, samples/s plain "
              f"{times['plain']['samples_per_s']:.1f} / distributed "
              f"{times['world1']['samples_per_s']:.1f} / distributed "
              f"{times['world1_again']['samples_per_s']:.1f} / plain "
              f"{times['plain_again']['samples_per_s']:.1f}", flush=True)
    finally:
        dist.destroy_process_group()
    return out


def dp_cli_refused() -> dict:
    """``cli train --num-devices`` one more than the visible cards exits 1
    with JAX's ``make_mesh`` error before it starts a process."""
    import io

    n = torch.cuda.device_count() + 1
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc, _ = cli_main(["train", "--data-dir", "no-such-dir",
                          "--num-devices", str(n)])
    text = err.getvalue().strip()
    print(f"cli train --num-devices {n}: exit code {rc}, {text!r}",
          flush=True)
    assert rc == 1 and f"requested {n} devices, only {n - 1} visible" in \
        text, (rc, text)
    return {"num_devices": n, "exit_code": rc, "stderr": text}


def dp_engines(smi) -> dict:
    """The production U-Net and flow engines with two replicas on cuda:0
    (a mesh of two cards that are one) against the unmeshed engines at
    b8 1080p: each replica's chunk of 4 launches the head (and the
    sampler) once; both timed (``time_engine``)."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    f1, f2 = frames(8, 1080, 1920, seed=51)
    out, launches = {}, collections.Counter()
    for name, kw, seed, per_replica in (
            ("unet", PROD, 52, dict(refine_head=1)),
            ("flow", FLOW_PROD, 53, dict(refine_head=1, sample_fused=1))):
        cfg = ModelConfig(**kw)
        plain = InterpolationEngine.random_init(cfg, seed=seed)
        meshed = InterpolationEngine.random_init(cfg, seed=seed, mesh=mesh)
        want = plain.interpolate_batch(f1, f2)
        reset_counts()
        got = meshed.interpolate_batch(f1, f2)
        counted = main_counts()
        diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
        rec = {"launches": counted, "max_uint8_diff": int(diff.max()),
               "share_over_1": float((diff > 1).mean())}
        rec.update(time_engine(plain, f"{name}_plain", smi, ((8, 5),)))
        rec.update(time_engine(meshed, f"{name}_mesh2", smi, ((8, 5),)))
        print(f"[{smi}] data parallel engine {name}: 2 replicas on cuda:0 "
              f"vs unmeshed at b8 1080p: max uint8 diff {rec['max_uint8_diff']}"
              f" ({rec['share_over_1']:.3g} of pixels over 1); launches "
              f"{counted}", flush=True)
        assert counted == dict(NO_LAUNCHES, **{
            k: 2 * v for k, v in per_replica.items()}), counted
        assert rec["max_uint8_diff"] <= 1, rec
        launches[f"refine_head_{'w64' if name == 'unet' else 'w16'}"] += \
            counted["refine_head"]
        launches["sample_fused"] += counted["sample_fused"]
        out[name] = rec
        del plain, meshed
    out["launches"] = dict(launches)
    return out


def split_check(label, plain, meshed, f1, f2, per_window) -> dict:
    """``meshed`` (a height split over two parts) against ``plain`` on one
    batch, counts set to 0 just before the meshed call and read after:
    within 1 LSB, each kernel of ``per_window`` launched that many times
    in each window."""
    from ai_based_frame_interpolation_torch.parallel.sharding import (
        halo_rows, row_parts)

    cfg = plain.cfg
    hp = -(-f1.shape[1] // cfg.pad_multiple) * cfg.pad_multiple
    parts = row_parts(hp, 2, cfg.pad_multiple, halo_rows(cfg))
    want = plain.interpolate_batch(f1, f2)
    reset_counts()
    got = meshed.interpolate_batch(f1, f2)
    counted = main_counts()
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    rec = {"launches": counted, "max_uint8_diff": int(diff.max()),
           "share_over_1": float((diff > 1).mean()), "padded_rows": hp,
           "windows": [[lo, hi] for _, _, lo, hi in parts],
           "rows_computed": sum(hi - lo for _, _, lo, hi in parts),
           "rows_kept": hp}
    print(f"height split {label}: windows {rec['windows']} of {hp} padded "
          f"rows ({rec['rows_computed']} computed, {hp} kept); max uint8 "
          f"diff {rec['max_uint8_diff']}; launches {counted}", flush=True)
    assert rec["max_uint8_diff"] <= 1, rec
    assert counted == dict(NO_LAUNCHES, **{
        k: len(parts) * v for k, v in per_window.items()}), counted
    return rec


def dp_height_split(smi) -> dict:
    """The height split on cuda:0 (two parts of one card): the production
    U-Net and flow engines against the unmeshed ones on a b1 pair at
    1080x1920 and 2160x3840 (the head, and the flow sampler, once per
    window) and on a 4-frame stream at batch_pairs 2 (its 1-pair tail
    split by height), each engine timed at b1 beside the unmeshed one;
    then the U-Net with ``core_impl="pallas"`` at 2160x3840 (the option
    core in each window)."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cuda:0", "cuda:0"])
    out, launches = {}, collections.Counter()
    for name, kw, seed, per_window in (
            ("unet", PROD, 54, dict(refine_head=1)),
            ("flow", FLOW_PROD, 55, dict(refine_head=1, sample_fused=1))):
        cfg = ModelConfig(**kw)
        plain = InterpolationEngine.random_init(cfg, seed=seed)
        meshed = InterpolationEngine.random_init(cfg, seed=seed, mesh=mesh)
        rec = {}
        for hw in ((1080, 1920), (2160, 3840)):
            f1, f2 = frames(1, *hw, seed=56)
            rec[f"{hw[0]}p"] = split_check(f"{name} {hw[0]}x{hw[1]}", plain,
                                           meshed, f1, f2, per_window)
            rec.update(time_engine(plain, f"{name}_plain_{hw[0]}", smi,
                                   ((1, 10),), hw))
            rec.update(time_engine(meshed, f"{name}_split2_{hw[0]}", smi,
                                   ((1, 10),), hw))
        f1, f2 = frames(2, 1080, 1920, seed=57)
        clip = [f1[0], f2[0], f1[1], f2[1]]
        want = list(plain.interpolate_video_frames(clip, 2, batch_pairs=2))
        reset_counts()
        got = list(meshed.interpolate_video_frames(clip, 2, batch_pairs=2))
        counted = main_counts()
        diff = max(int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
                   for a, b in zip(got, want))
        # the 2-pair batch split by batch (one launch a replica), the 1-pair
        # tail by height (one a window; the flow config's 1080p frame runs
        # whole, one window)
        calls = 2 + len(rec["1080p"]["windows"])
        rec["stream_tail"] = {"frames_out": len(got), "max_uint8_diff": diff,
                              "launches": counted}
        print(f"height split {name} stream of 4 frames at batch_pairs 2: "
              f"{len(got)} frames, max uint8 diff {diff}; launches {counted}",
              flush=True)
        assert len(got) == len(want) == 7 and diff <= 1
        assert counted == dict(NO_LAUNCHES, **{
            k: calls * v for k, v in per_window.items()}), counted
        for run in (rec["1080p"], rec["2160p"], rec["stream_tail"]):
            launches[f"refine_head_{'w64' if name == 'unet' else 'w16'}"] += \
                run["launches"]["refine_head"]
            launches["sample_fused"] += run["launches"]["sample_fused"]
        out[name] = rec
        del plain, meshed
    cfg = ModelConfig(**PROD)
    plain = InterpolationEngine.random_init(cfg, seed=58, core_impl="pallas")
    meshed = InterpolationEngine.random_init(cfg, seed=58, core_impl="pallas",
                                             mesh=mesh)
    f1, f2 = frames(1, 2160, 3840, seed=59)
    rec = split_check("unet core_impl=pallas 2160x3840", plain, meshed, f1,
                      f2, dict(refine_head=1, double_conv=3,
                               up_double_conv=2))
    rec.update(time_engine(plain, "unet_core_plain_2160", smi, ((1, 10),),
                           (2160, 3840)))
    rec.update(time_engine(meshed, "unet_core_split2_2160", smi, ((1, 10),),
                           (2160, 3840)))
    out["unet_core"] = rec
    for k in ("refine_head", "double_conv", "up_double_conv"):
        launches["refine_head_w64" if k == "refine_head" else k] += \
            rec["launches"][k]
    out["launches"] = dict(launches)
    return out


def parallel_path(record, smi) -> dict:
    """Phase 12 (module docstring): data parallel on the one card."""
    out = {"world_one": dp_world_one(smi)}
    out["two_ranks"] = dp_two_ranks(smi)
    assert all(out["two_ranks"][k]["ok"] for k in DP_STEPS), out["two_ranks"]
    out["cli_refused"] = dp_cli_refused()
    out["engines"] = dp_engines(smi)
    out["height_split"] = dp_height_split(smi)
    ev = out["world_one"]["eval_launches"]
    launches = collections.Counter(out["engines"]["launches"])
    launches.update(out["height_split"]["launches"])
    launches["refine_head_w64"] += ev["refine_head"]
    launches["ssim_eval"] += ev["ssim_eval"]
    out["launches"] = dict(launches)
    record["parallel"] = out
    return out


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


def profile_call(fn, top: int = 6) -> dict:
    """One call of ``fn`` under torch.profiler: its wall ms, the device's
    busy ms (kernels and copies; None if none was recorded), the device
    kernels it ran, and the host ops with the most self CPU time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = prof.key_averages()
    dev = [ev for ev in evs
           if ev.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0))
               for ev in dev) / 1e3
    host = sorted((ev for ev in evs
                   if ev.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda ev: -ev.self_cpu_time_total)[:top]
    return {"profiled_ms": wall, "device_busy_ms": busy or None,
            "device_busy_share": busy / wall if busy else None,
            "device_kernels": sum(ev.count for ev in dev),
            "host_ops_self_ms": {ev.key: [ev.self_cpu_time_total / 1e3,
                                          ev.count] for ev in host}}


def device_busy_ms(fn):
    """(host ms, device busy ms) of one call of ``fn`` under torch.profiler:
    the device time of every kernel and copy; None if the profiler
    recorded no device time."""
    p = profile_call(fn)
    return p["profiled_ms"], p["device_busy_ms"]


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


def video_frames(n, h, w, seed):
    """``n`` consecutive gray frames (a pattern moving 6 px a frame, with
    noise), uint8 HWC."""
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 90 * np.sin(x / 23.0) * np.cos(y / 17.0)
    return [np.clip(np.roll(base, 6 * i, axis=1) + gen.normal(0, 8, (h, w)),
                    0, 255).astype(np.uint8)[..., None] for i in range(n)]


def retime_schedule(n_frames, rate, batch_pairs, eps=1e-6):
    """What ``retime_video_frames`` should output for ``n_frames`` inputs:
    per output frame k, ``(i, None)`` (input frame i, passed through) or
    ``(i, t)`` (pair i at time t); and the sampler calls it should make,
    the largest time count of each group of ``batch_pairs`` pairs summed
    over the groups. Worked out here from k / rate, for the check."""
    out, per_pair = [], [0] * (n_frames - 1)
    for k in range(int((n_frames - 1) * rate + eps) + 1):
        tau = k / rate
        i = min(int(tau + eps), n_frames - 1)
        t = tau - i
        if t <= eps:
            out.append((i, None))
        else:
            out.append((i, t))
            per_pair[i] += 1
    calls = sum(max(per_pair[g:g + batch_pairs])
                for g in range(0, n_frames - 1, batch_pairs))
    return out, calls


def check_video(label, got, originals, mids, launches, routes, want_launches,
                want_routes) -> dict:
    """A checked stream: the launch and route counts, ``originals``
    ({output index: input frame}) bit for bit, every other output within
    1 LSB of ``mids`` ({output index: the frame from a pair call})."""
    assert launches == want_launches, \
        f"video {label}: launches {launches}, not {want_launches}"
    assert routes == want_routes, f"video {label}: routes {routes}"
    assert len(got) == len(originals) + len(mids), f"video {label}: " \
        f"{len(got)} frames, not {len(originals) + len(mids)}"
    for k, frame in originals.items():
        assert got[k].dtype == np.uint8 and np.array_equal(got[k], frame), \
            f"video {label}: original at {k} changed"
    du = max(int(np.abs(got[k].astype(np.int16) - m.astype(np.int16)).max())
             for k, m in mids.items())
    print(f"video {label}: {len(got)} frames, launches {launches}, originals "
          f"bit for bit, in-betweens max uint8 diff {du} vs the pair calls",
          flush=True)
    assert du <= 1
    return {"frames": len(got), "launches": launches, "routes": routes,
            "max_uint8_diff_vs_pairs": du}


# the port's spans (utils/profiling.py) that time a stream's host steps,
# under the keys of this smoke's record
STREAM_SPLIT = {"engine.upload": "upload_s", "engine.enqueue": "enqueue_s",
                "engine.download": "download_wait_s",
                "stream.interleave": "interleave_s"}


def time_stream(smi, label, run, frames) -> dict:
    """One warm run of a stream generator over ``frames`` (in host memory),
    host clock over the whole generator; then one under torch.profiler
    for the device's busy share and the host split the port's spans
    record (``STREAM_SPLIT``; the rest is the generator's own work)."""
    from ai_based_frame_interpolation_torch.utils import profiling

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    n = sum(1 for _ in run(frames))
    s = time.perf_counter() - t0
    profiling.reset()
    wall_ms, busy_ms = device_busy_ms(lambda: sum(1 for _ in run(frames)))
    totals = profiling.totals()
    split = {key: totals.get(span, {}).get("seconds", 0.0)
             for span, key in STREAM_SPLIT.items()}
    split["total_s"] = wall_ms / 1e3
    split["rest_s"] = split["total_s"] - sum(
        v for k, v in split.items() if k != "total_s")
    share = None if busy_ms is None else busy_ms / wall_ms
    print(f"[{smi}] video {label}: {len(frames)} 1080p frames in, {n} out in "
          f"{s * 1e3:.3f} ms, {n / s:.3f} output fps (host clock); the "
          f"profiled run's host split, ms: " + ", ".join(
              f"{k[:-2]} {v * 1e3:.3f}" for k, v in split.items()) +
          f"; device busy "
          f"{'not recorded' if busy_ms is None else f'{busy_ms:.3f} ms'}",
          flush=True)
    return {"frames_in": len(frames), "frames_out": n, "seconds": s,
            "output_fps": n / s, "host_split_s": split,
            "profiled_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": share}


def time_bare(smi, label, fn, args, outputs, iters=10) -> dict:
    """ms per call of an engine's pair function on device inputs (CUDA
    events) and the output fps of ``outputs`` frames a call."""
    ms = cuda_ms(lambda: fn(*args), iters, warmup=1)
    print(f"[{smi}] bare {label}: {ms:.3f} ms/call, "
          f"{outputs / (ms / 1e3):.3f} output fps", flush=True)
    return {"ms_per_call": ms, "output_fps": outputs / (ms / 1e3)}


def video_path(record, unet, flow, smi):
    """The video paths at 1080p gray on ``VIDEO_FRAMES`` seeded frames, each
    stream's counts set to 0 just before and read just after: the U-Net
    production engine at 2x and 4x (``refine_head`` w64 once per forward:
    1 and 3 a dispatch), the flow production engine retiming 24 -> 60 fps
    (``retime_video_frames`` at 2.5; one ``sample_fused`` and one w16 head
    launch per padded time) and the tower at 2x (the shared-encode stream;
    one w64 head launch a dispatch). Then each stream warm over
    ``VIDEO_TIMED_FRAMES`` frames with the host clock and once profiled,
    and the bare pair functions it is compared with. Returns the record
    and the launches under each route, for the kernels line."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)

    fr = video_frames(VIDEO_FRAMES, 1080, 1920, seed=5)
    n = len(fr) - 1
    out, routes_total = {}, collections.Counter()
    w64 = "refine_head w64/w64/bfloat16"

    def counted(run):
        reset_counts()
        got = list(run())
        routes = route_counts()
        launches = main_counts()
        routes_total.update(routes)
        return got, launches, routes

    # U-Net production, 2x and 4x
    for factor in (2, 4):
        got, launches, routes = counted(
            lambda: unet.interpolate_video_frames(iter(fr), factor, 8))
        if factor == 2:
            want = unet.interpolate_batch(np.stack(fr[:-1]),
                                          np.stack(fr[1:]))[:, None]
        else:
            # the 4x pair function on the stream's batches of 8 pairs: the
            # bisection's second level starts from the first level's bf16
            # midpoints, so at another batch size (cuDNN picks other
            # algorithms) the quarter frames can move 2 LSB (recorded
            # below against generate_intermediate_frames, one pair a call)
            fn = unet._pair_fn(factor - 1, 2)
            want = np.concatenate([fn(unet.model, unet._put(np.stack(
                fr[g:g + 8])), unet._put(np.stack(fr[g + 1:g + 9])))
                .cpu().numpy() for g in range(0, n, 8)])
        mids = {factor * i + 1 + q: want[i, q] for i in range(n)
                for q in range(factor - 1)}
        per = 2 * (factor - 1)          # 2 dispatches x the forwards
        out[f"unet_{factor}x"] = check_video(
            f"U-Net {factor}x", got,
            {factor * i: f for i, f in enumerate(fr)}, mids, launches,
            routes, dict(NO_LAUNCHES, refine_head=per), {w64: per})
        if factor == 4:
            b1 = [np.stack(unet.generate_intermediate_frames(
                fr[i], fr[i + 1], 3)) for i in range(n)]
            by_time = [max(int(np.abs(got[4 * i + 1 + q].astype(np.int16)
                                      - b1[i][q].astype(np.int16)).max())
                           for i in range(n)) for q in range(3)]
            print(f"video U-Net 4x vs generate_intermediate_frames (one pair "
                  f"a call): max uint8 diff at t = 1/4, 1/2, 3/4: {by_time}",
                  flush=True)
            out["unet_4x"]["max_uint8_diff_vs_b1_by_time"] = by_time

    # flow production, retiming 24 -> 60 fps over 9 frames
    fr9, rate = fr[:9], 2.5
    sched, calls = retime_schedule(len(fr9), rate, 8)
    got, launches, routes = counted(
        lambda: flow.retime_video_frames(iter(fr9), rate, batch_pairs=8))
    originals = {k: fr9[i] for k, (i, t) in enumerate(sched) if t is None}
    mids = {}
    for i in range(len(fr9) - 1):
        ks = [k for k, (j, t) in enumerate(sched) if j == i and t is not None]
        for k, m in zip(ks, flow.interpolate_at(
                fr9[i], fr9[i + 1], [sched[k][1] for k in ks])):
            mids[k] = m
    out["flow_retime_2.5"] = check_video(
        f"flow retime x{rate}", got, originals, mids, launches, routes,
        dict(NO_LAUNCHES, refine_head=calls, sample_fused=calls),
        {"refine_head w16/w16/bfloat16": calls})
    out["flow_retime_2.5"]["padded_time_calls"] = calls

    # the tower at 2x: each frame encoded once
    tower = InterpolationEngine.random_init(ModelConfig(**TOWER_PROD),
                                            seed=0)
    got, launches, routes = counted(
        lambda: tower.interpolate_video_frames(iter(fr), 2, 8))
    want = tower.interpolate_batch(np.stack(fr[:-1]), np.stack(fr[1:]))
    out["tower_2x"] = check_video(
        "tower 2x", got, {2 * i: f for i, f in enumerate(fr)},
        {2 * i + 1: want[i] for i in range(n)}, launches, routes,
        dict(NO_LAUNCHES, refine_head=2), {w64: 2})

    # timings: each stream warm, then the bare pair functions at b8
    timed = video_frames(VIDEO_TIMED_FRAMES, 1080, 1920, seed=6)
    for key, run in (
            ("unet_2x", lambda f: unet.interpolate_video_frames(iter(f), 2)),
            ("unet_4x", lambda f: unet.interpolate_video_frames(iter(f), 4)),
            ("flow_retime_2.5",
             lambda f: flow.retime_video_frames(iter(f), rate)),
            ("tower_2x",
             lambda f: tower.interpolate_video_frames(iter(f), 2))):
        out[key]["stream"] = time_stream(smi, key, run, timed)
    # b8 on device inputs: 9 consecutive frames, their 8 pairs; the U-Net
    # at 2x is phase 5's time_engine (the bare output fps beside it there)
    x9 = unet._put(np.stack(timed[:9]))
    pairs = (x9[:-1], x9[1:])
    out["unet_4x"]["bare"] = time_bare(
        smi, "U-Net _pair_fn(3, 2) b8 (4x)", unet._pair_fn(3, 2),
        (unet.model, *pairs), 32)
    # the timed stream's times: pairs alternate (0.4, 0.8) and (0.2, 0.6)
    ts = torch.tensor([[0.4, 0.2] * 4, [0.8, 0.6] * 4], device=x9.device)
    out["flow_retime_2.5"]["bare"] = time_bare(
        smi, "flow _time_fn(2) b8 (retime x2.5: 20 frames a call)",
        flow._time_fn(2), (flow.model, *pairs, ts), 20)
    out["tower_2x"]["bare"] = time_bare(
        smi, "tower _pair_fn(1, 1) b8 (2x)", tower._pair_fn(1, 1),
        (tower.model, *pairs), 16)
    out["tower_2x"]["bare_stream_step"] = time_bare(
        smi, "tower _tower_stream_fn on 9 frames (2x)",
        tower._tower_stream_fn(), (tower.model, x9), 16)
    del tower, x9, pairs
    record["video"] = out
    return out, routes_total


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


def time_engine(engine, label, smi, sizes, hw=(1080, 1920)) -> dict:
    """ms per gray 2x call at ``hw`` (1080p), midpoints/s and output fps
    (originals + midpoints, as bench.py counts them) at each (batch,
    iterations)."""
    out = {}
    fn = engine._pair_fn(1, 1)
    for b, iters in sizes:
        g1, g2 = frames(b, *hw, seed=3)
        d1, d2 = engine._put(g1), engine._put(g2)
        ms = cuda_ms(lambda: fn(engine.model, d1, d2), iters, warmup=1)
        pairs_s = b / (ms / 1e3)
        out[f"{label}_b{b}"] = {"ms_per_call": ms, "midpoints_per_s": pairs_s,
                                "output_fps": 2 * pairs_s}
        print(f"[{smi}] {label} engine {hw[0]}x{hw[1]} gray 2x b={b}: "
              f"{ms:.3f} ms/call, "
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


TRAIN_CLIPS = 6               # of 16 frames: 84 triplets, 67 train / 17 val
TRAIN_HW = 256                # DataConfig's default, the reference's size
TRAIN_BATCH = 8
TRAIN_TIMED_STEPS = 10
# the flow losses on, as the JAX CLI's --flow-smooth/--flow-photo/--census
FLOW_TRAIN_LOSS = dict(flow_smooth_weight=0.01, flow_photo_weight=0.1,
                       census_weight=0.1)


def train_model_of(kw, seed):
    """A model of config ``kw`` (unfolded BatchNorm, bf16 compute, f32
    weights, as the JAX CLI's ``cmd_train`` builds it) with Flax's default
    init drawn from ``seed``."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import _init_weights
    from ai_based_frame_interpolation_torch.models import build_model

    model = build_model(ModelConfig(**kw))
    _init_weights(model, torch.Generator().manual_seed(seed))
    return model


def check_grads(model, label) -> None:
    """Every parameter's gradient finite and somewhere non-zero."""
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not bool(torch.isfinite(p.grad).all())
           or not bool((p.grad != 0).any())]
    assert not bad, f"{label}: gradients missing, non-finite or zero: {bad}"


def check_wrapper_guard(model) -> None:
    """Every kernel wrapper refuses grad-requiring inputs on the card: the
    head with the model's own weights, the sampler with a field that
    requires grad, the core and direct-conv wrappers with weights that
    do."""
    from ai_based_frame_interpolation_torch.ops.conv_direct import (
        conv_direct, head_out_direct)
    from ai_based_frame_interpolation_torch.ops.dconv_fused import (
        double_conv_fused, up_double_conv_fused)
    from ai_based_frame_interpolation_torch.ops.refine import refine_head
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        sample_fused)

    def cuda(*shape, grad=False):
        return torch.zeros(shape, device="cuda", requires_grad=grad)

    y, x = cuda(1, 64, 64, 1), cuda(1, 64, 64, 8)
    w, b = cuda(8, 8, 3, 3, grad=True), cuda(8)
    calls = {
        "refine_head": lambda: refine_head(y, (y, y), model.head_params()),
        "sample_fused": lambda: sample_fused(
            y, y, cuda(1, 64, 64, 2, grad=True), cuda(1, 64, 64, 1),
            cuda(1)),
        "double_conv_fused": lambda: double_conv_fused(x, w, b, w, b),
        "up_double_conv_fused": lambda: up_double_conv_fused(
            x, cuda(1, 32, 32, 8), w, b, w, b),
        "conv_direct": lambda: conv_direct(x, cuda(9, 8, 8, grad=True), b),
        "head_out_direct": lambda: head_out_direct(x, cuda(8, 1, grad=True),
                                                   cuda(1), y)}
    for name, call in calls.items():
        try:
            call()
        except RuntimeError as e:
            assert name in str(e) and "no backward" in str(e), e
        else:
            raise AssertionError(f"{name} ran under grad on grad-requiring "
                                 "inputs")
    print(f"train: {', '.join(calls)} refuse grad-requiring inputs on the "
          "card", flush=True)


def check_validation(state, val_batches) -> dict:
    """The validation forward (the scored copy ``eval_step`` runs, its head
    packed once from the EMA weights) against the same unfolded model
    composed with the plain head on the current EMA weights, and the SSIM
    kernel against the plain metric on the same uint8 predictions."""
    import copy

    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8, normalize_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head_reference)
    from ai_based_frame_interpolation_torch.ops.ssim import ssim_eval
    from ai_based_frame_interpolation_torch.ops.ssim_fused import (
        ssim_eval_auto)
    from ai_based_frame_interpolation_torch.train.loop import _scored_model

    scored = _scored_model(state, use_ema=True)
    plain = copy.deepcopy(state.model).requires_grad_(False)
    nchw = lambda x: normalize_uint8(x).permute(0, 3, 1, 2)  # noqa: E731
    nhwc = lambda x: x.permute(0, 2, 3, 1)  # noqa: E731
    du, ds = 0, 0.0
    with torch.no_grad():
        for name, p in plain.named_parameters():
            p.copy_(state.ema_params[name])
        for vb in val_batches:
            x0, x1 = nchw(vb["f0"]), nchw(vb["f1"])
            got = denormalize_to_uint8(nhwc(scored(x0, x1)))
            y = plain(x0, x1, skip_refine=True)
            want = denormalize_to_uint8(refine_head_reference(
                nhwc(y), (nhwc(x0), nhwc(x1)), plain.head_params(),
                plain.compute_dtype))
            du = max(du, int((got.int() - want.int()).abs().max()))
            ds = max(ds, float((ssim_eval_auto(got, vb["gt"])
                                - ssim_eval(got, vb["gt"])).abs().max()))
    print(f"train: validation predictions vs the plain head on the EMA "
          f"weights: max uint8 diff {du}; SSIM kernel vs plain {ds:.3g}",
          flush=True)
    assert du <= 1 and ds <= SSIM_BOUND
    return {"max_uint8_diff_vs_plain": du, "ssim_max_abs_err": ds}


def check_resume(state, ckpt, tcfg, batch) -> dict:
    """``latest`` restored into a fresh state equals ``state`` bit for bit;
    the next step's loss on both within 1e-3 relative."""
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state, train_step)

    fresh = create_train_state(train_model_of(PROD, 2), None, tcfg)
    fresh, epoch, _ = ckpt.restore(fresh, which="latest")
    assert epoch == tcfg.epochs and fresh.step == state.step
    want, got = state.model.state_dict(), fresh.model.state_dict()
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert all(torch.equal(state.ema_params[k], fresh.ema_params[k])
               for k in state.ema_params)
    for p, q in zip(state.model.parameters(), fresh.model.parameters()):
        a, b = state.tx.state[p], fresh.tx.state[q]
        assert all(torch.equal(a[k], b[k]) for k in
                   ("step", "exp_avg", "exp_avg_sq")), "Adam state differs"
    _, loss_a = train_step(state, batch, tcfg.loss, ema_decay=tcfg.ema_decay)
    _, loss_b = train_step(fresh, batch, tcfg.loss, ema_decay=tcfg.ema_decay)
    rel = abs(float(loss_b) - float(loss_a)) / abs(float(loss_a))
    print(f"train: resumed from latest (step {fresh.step - 1}) bit for bit; "
          f"next step's loss {float(loss_b):.6f} vs uninterrupted "
          f"{float(loss_a):.6f} (relative {rel:.3g})", flush=True)
    assert rel <= 1e-3
    return {"step": fresh.step - 1, "next_loss_rel_diff": rel}


def check_export(ckpt, tcfg, val_batch) -> dict:
    """``best``'s EMA weights exported into the checkpoint directory (as
    ``cli train`` exports them) and served by ``from_checkpoint``: 256x256
    midpoints on the w64 head within 1 LSB of the plain composition on the
    exported weights."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.train.checkpoint import (
        save_variables)
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state)

    best = create_train_state(train_model_of(PROD, 3), None, tcfg)
    best, _, _ = ckpt.restore(best, which="best")
    out_dir = ckpt.directory
    save_variables(out_dir, best.variables(use_ema=True), ModelConfig(**PROD))
    engine = InterpolationEngine.from_checkpoint(out_dir)
    f1, f2 = (val_batch[k].cpu().numpy() for k in ("f0", "f1"))
    reset_counts()
    out = engine.interpolate_batch(f1, f2)
    launches = main_counts()
    assert launches == dict(NO_LAUNCHES, refine_head=1), launches
    want = reference_midpoints(engine, f1, f2).cpu().numpy()
    du = int(np.abs(out.astype(np.int16) - want.astype(np.int16)).max())
    print(f"train: best's EMA export through from_checkpoint: {out.shape} "
          f"max uint8 diff vs plain {du}; launches {launches}", flush=True)
    assert out.shape == (len(f1), TRAIN_HW, TRAIN_HW, 1) and du <= 1
    return {"max_uint8_diff_vs_plain": du, "launches": launches,
            "dir": out_dir}


def time_train(smi, state, batch, loss_cfg, ema_decay) -> dict:
    """ms per warm train_step (CUDA events), samples/s, the peak device
    memory of those steps and a profile of one step (``profile_call``)."""
    from ai_based_frame_interpolation_torch.train.loop import train_step

    def step():
        train_step(state, batch, loss_cfg, ema_decay=ema_decay)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = cuda_ms(step, TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    return dict(profile_call(step), ms=ms,
                samples_per_s=TRAIN_BATCH * 1e3 / ms, peak_bytes=peak,
                card=smi)


def train_path(record, smi, ckpt_dir) -> dict:
    """Phase 8 (module docstring): the trainer on the card; its checkpoints
    and export go to ``ckpt_dir``, which phase 10 reads."""
    from ai_based_frame_interpolation_torch.config import (
        LossConfig, TrainConfig)
    from ai_based_frame_interpolation_torch.data.loader import TripletLoader
    from ai_based_frame_interpolation_torch.data.synthetic import (
        write_scene_tree)
    from ai_based_frame_interpolation_torch.data.triplets import (
        scan_triplets, split_triplets)
    from ai_based_frame_interpolation_torch.train.checkpoint import (
        Checkpointer)
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state, eval_step, train_model, train_step)

    out = {}
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_scene_tree(os.path.join(root, "data"), num_videos=TRAIN_CLIPS,
                         num_frames=16, height=TRAIN_HW, width=TRAIN_HW)
        train_t, val_t = split_triplets(
            scan_triplets(os.path.join(root, "data")), 0.2, seed=0)
        out["data_s"] = time.perf_counter() - t0
        kw = dict(batch_size=TRAIN_BATCH, height=TRAIN_HW, width=TRAIN_HW,
                  num_workers=4)
        train_loader = TripletLoader(train_t, seed=1, **kw)
        val_loader = TripletLoader(val_t, shuffle=False,
                                   drop_remainder=False, **kw)
        batches, val_batches = list(train_loader), list(val_loader)
        print(f"train: {len(train_t)} train / {len(val_t)} val triplets "
              f"({TRAIN_CLIPS} clips written in {out['data_s']:.2f} s); "
              f"{len(batches)} train and {len(val_batches)} val batches",
              flush=True)

        # the U-Net production config: gradients, no kernel, the loss falls
        tcfg = TrainConfig(epochs=2, batch_size=TRAIN_BATCH,
                           learning_rate=1e-4, ema_decay=0.9)
        state = create_train_state(train_model_of(PROD, 0), None, tcfg)
        reset_counts()
        losses = []
        for k in range(5):
            state, loss = train_step(state, batches[0], tcfg.loss,
                                     ema_decay=tcfg.ema_decay)
            if k == 0:
                check_grads(state.model, "U-Net")
            losses.append(float(loss))
        launches = counts()
        print(f"train: U-Net 5 steps on one batch: loss {losses[0]:.6f} -> "
              f"{losses[-1]:.6f}; launches {launches}", flush=True)
        assert launches == NO_LAUNCHES and not route_counts(), launches
        assert losses[-1] < losses[0]
        out["unet_losses_one_batch"] = losses
        check_wrapper_guard(state.model)
        out["unet_step"] = time_train(smi, state, batches[0], tcfg.loss,
                                      tcfg.ema_decay)
        out["unet_eval_step_ms"] = cuda_ms(
            lambda: eval_step(state, val_batches[0], tcfg.loss, use_ema=True),
            TRAIN_TIMED_STEPS)
        del state

        # train_model: 2 epochs, validation on the kernels, checkpoints
        ckpt = Checkpointer(ckpt_dir)
        logs = []
        reset_counts()
        t0 = time.perf_counter()
        state, hist = train_model(train_model_of(PROD, 1), None, train_loader,
                                  val_loader, tcfg, checkpointer=ckpt,
                                  log_fn=logs.append)
        out["train_model_s"] = time.perf_counter() - t0
        launches = main_counts()
        n_val = tcfg.epochs * len(val_loader)
        for line in logs:
            print(f"train: {line}", flush=True)
        print(f"train: train_model launches {launches} (validation: "
              f"{n_val} val batches)", flush=True)
        assert launches == dict(NO_LAUNCHES, refine_head=n_val,
                                ssim_eval=n_val), launches
        assert state.step == tcfg.epochs * len(train_loader)
        out["train_model"] = {"history": dataclasses.asdict(hist),
                              "launches": launches}
        out["validation"] = check_validation(state, val_batches)
        out["resume"] = check_resume(state, ckpt, tcfg, batches[1])
        out["export"] = check_export(ckpt, tcfg, val_batches[0])
        del state

        # the flow production config with its losses on
        fcfg = TrainConfig(batch_size=TRAIN_BATCH, learning_rate=1e-4,
                           loss=LossConfig(**FLOW_TRAIN_LOSS))
        state = create_train_state(train_model_of(FLOW_PROD, 4), None, fcfg)
        reset_counts()
        for k in range(2):
            state, loss = train_step(state, batches[k], fcfg.loss)
            check_grads(state.model, "flow")
        launches = counts()
        assert launches == NO_LAUNCHES and not route_counts(), launches
        reset_counts()
        m = eval_step(state, val_batches[0], fcfg.loss)
        launches = main_counts()
        print(f"train: flow 2 steps, loss {float(loss):.6f}; validation "
              f"{ {k: round(float(v), 4) for k, v in m.items()} } launches "
              f"{launches}", flush=True)
        assert launches == dict(NO_LAUNCHES, refine_head=1, sample_fused=1,
                                ssim_eval=1), launches
        out["flow_validation_launches"] = launches
        out["flow_step"] = time_train(smi, state, batches[0], fcfg.loss, 0.0)
        del state
    u, f = out["unet_step"], out["flow_step"]
    share = lambda t: ("not recorded" if t["device_busy_share"] is None  # noqa: E731
                       else f"{100 * t['device_busy_share']:.2f}%")
    print(f"[{smi}] train (b{TRAIN_BATCH} {TRAIN_HW}x{TRAIN_HW} gray, bf16): "
          f"U-Net production {u['ms']:.3f} ms/step, "
          f"{u['samples_per_s']:.1f} samples/s, peak "
          f"{u['peak_bytes'] / 2**30:.3f} GiB, busy {share(u)} of a profiled "
          f"step; flow production {f['ms']:.3f} ms/step, "
          f"{f['samples_per_s']:.1f} samples/s, peak "
          f"{f['peak_bytes'] / 2**30:.3f} GiB, busy {share(f)}; U-Net "
          f"eval_step {out['unet_eval_step_ms']:.3f} ms", flush=True)
    for name, t in (("U-Net", u), ("flow", f)):
        ops = ", ".join(f"{k} {v[0]:.2f} ms x{v[1]}"
                        for k, v in t["host_ops_self_ms"].items())
        print(f"[{smi}] train: {name} step profile: {t['device_kernels']} "
              f"device kernels; host self time by op: {ops}", flush=True)
    record["train"] = out
    return out


SERVE_HW = (256, 256)          # the serving resolution (ServeConfig's users)
SERVE_TIMED = 60               # requests per timed single-client loop
SERVE_CLIENTS = 8
SERVE_CLIENT_REQUESTS = 20     # per client in the concurrent loop
# bisected in-betweens against the engine at another batch size: up to 2
# LSB at t=3/4 from bf16 bisection (phase 7's 4x record); midpoints 1 LSB
BISECT_LSB = 2


def multipart(fields) -> tuple:
    """(body, content type) of a multipart/form-data request: a value is a
    (filename, content type, bytes) file or a form field."""
    boundary = "smokeboundary7f3a"
    out = []
    for name, value in fields.items():
        out.append(f"--{boundary}\r\n".encode())
        if isinstance(value, tuple):
            fname, ctype, data = value
            out.append(f'Content-Disposition: form-data; name="{name}"; '
                       f'filename="{fname}"\r\nContent-Type: {ctype}\r\n\r\n'
                       .encode() + data)
        else:
            out.append(f'Content-Disposition: form-data; name="{name}"'
                       f'\r\n\r\n{value}'.encode())
        out.append(b"\r\n")
    out.append(f"--{boundary}--\r\n".encode())
    return b"".join(out), f"multipart/form-data; boundary={boundary}"


def http_call(port, method, path, body=None, ctype=None, timeout=300,
              nodelay=False):
    """(status, headers, body bytes) of one request on a new connection
    (with TCP_NODELAY on the client's socket when ``nodelay``)."""
    import http.client
    import socket

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if nodelay:
            conn.connect()
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn.request(method, path, body=body,
                     headers={"Content-Type": ctype} if ctype else {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def png_frames(h, w, seed) -> tuple:
    """Two seeded gray frames and their PNG bytes (``ops/png.py``)."""
    from ai_based_frame_interpolation_torch.ops.png import encode_png

    f1, f2 = frames(1, h, w, seed=seed)
    return f1[0], f2[0], encode_png(f1[0]), encode_png(f2[0])


def decode_frames(data) -> list:
    """The base64 PNG frames of an /interpolate-frames answer (HWC gray)."""
    import base64

    from ai_based_frame_interpolation_torch.ops.png import decode_png, to_gray

    return [to_gray(decode_png(base64.b64decode(f))) for f in data["frames"]]


def post_frames(port, p1, p2, nodelay=False, **fields) -> list:
    """POST /interpolate-frames; the returned frames decoded (HWC gray)."""
    body, ctype = multipart(dict(frame1=("a.png", "image/png", p1),
                                 frame2=("b.png", "image/png", p2), **fields))
    status, _, blob = http_call(port, "POST", "/interpolate-frames", body,
                                ctype, nodelay=nodelay)
    assert status == 200, (status, blob[:300])
    return decode_frames(json.loads(blob))


def max_lsb(got, want) -> int:
    return max(int(np.abs(g.astype(np.int16) - w.astype(np.int16)).max())
               for g, w in zip(got, want))


def percentile(xs, q) -> float:
    return float(np.percentile(np.asarray(xs), q))


def serve_launch_check(label, launches, want) -> dict:
    print(f"serve: {label}: launches {launches}", flush=True)
    assert launches == dict(NO_LAUNCHES, **want), (label, launches, want)
    return launches


def time_requests(port, p1, p2, num, n, nodelay=False) -> list:
    """Host ms of ``n`` sequential /interpolate-frames requests, each with
    the client's decode of the answer."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        post_frames(port, p1, p2, nodelay=nodelay, num_intermediate=num)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def time_service(service, p1, p2, num, n, fresh_thread=False) -> list:
    """Host ms of ``n`` in-process ``interpolate_frames`` calls on parsed
    parts (no HTTP), each with the same client-side decode; with
    ``fresh_thread`` each call runs on a new thread, as the HTTP server
    runs each connection."""
    from ai_based_frame_interpolation_torch.serve.server import (
        parse_multipart)

    parts = parse_multipart(*multipart(dict(
        frame1=("a.png", "image/png", p1), frame2=("b.png", "image/png", p2),
        num_intermediate=num)))

    def call():
        decode_frames(service.interpolate_frames(parts))

    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        if fresh_thread:
            worker = threading.Thread(target=call)
            worker.start()
            worker.join()
        else:
            call()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def engine_ms(engine, f1, f2, n, fresh_thread) -> list:
    """Host ms of ``n`` ``generate_intermediate_frames(f1, f2, 1)`` calls
    of the engine itself, on this thread or each on a new thread (as the
    JAX batcher's design would run them under the HTTP server)."""
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        if fresh_thread:
            worker = threading.Thread(
                target=engine.generate_intermediate_frames,
                args=(f1, f2, 1))
            worker.start()
            worker.join()
        else:
            engine.generate_intermediate_frames(f1, f2, 1)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def loopback_ms(up: int, down: int, n: int, unix: bool) -> list:
    """Host ms of ``n`` raw socket round trips on this machine: ``up``
    bytes sent, ``down`` bytes answered once they have all arrived, no
    HTTP; over TCP on 127.0.0.1, or a Unix socket pair."""
    import socket

    def serve(conn):
        with conn:
            for _ in range(n):
                got = 0
                while got < up:
                    got += len(conn.recv(1 << 16))
                conn.sendall(bytes(down))

    if unix:
        cli, srv = socket.socketpair()
        worker = threading.Thread(target=serve, args=(srv,))
    else:
        lsock = socket.create_server(("127.0.0.1", 0))
        cli = socket.create_connection(lsock.getsockname())
        worker = threading.Thread(target=lambda: serve(lsock.accept()[0]))
    worker.start()
    out = []
    with cli:
        for _ in range(n):
            t0 = time.perf_counter()
            cli.sendall(bytes(up))
            got = 0
            while got < down:
                got += len(cli.recv(1 << 16))
            out.append((time.perf_counter() - t0) * 1e3)
    worker.join(timeout=60)
    if not unix:
        lsock.close()
    return out


def latency(ms) -> dict:
    return {"requests": len(ms), "p50_ms": percentile(ms, 50),
            "p95_ms": percentile(ms, 95), "mean_ms": float(np.mean(ms))}


def concurrent_requests(port, pairs, num, per_client) -> tuple:
    """``len(pairs)`` clients, each sending ``per_client``
    /interpolate-frames requests for its pair; (answers, wall seconds)."""
    answers = [None] * len(pairs)
    errors = []
    gate = threading.Barrier(len(pairs))

    def client(i):
        try:
            gate.wait(timeout=60)
            for _ in range(per_client):
                answers[i] = post_frames(port, pairs[i][2], pairs[i][3],
                                         num_intermediate=num)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(pairs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    assert not any(t.is_alive() for t in threads), "a client hung"
    if errors:
        raise errors[0]
    return answers, wall


def has_module(name) -> bool:
    import importlib.util

    return importlib.util.find_spec(name) is not None


def opencv_requests(port, p1, p2) -> dict:
    """/interpolate (3 in-betweens) and /evaluate-interpolation once each:
    {path: (status, headers, body)}."""
    out = {}
    for path, fields in (
            ("/interpolate", dict(num_intermediate=3, fps=30)),
            ("/evaluate-interpolation",
             dict(ground_truth=("g.png", "image/png", p1)))):
        body, ctype = multipart(dict(frame1=("a.png", "image/png", p1),
                                     frame2=("b.png", "image/png", p2),
                                     **fields))
        reset_counts()
        out[path] = http_call(port, "POST", path, body, ctype) + (
            main_counts(),)
    return out


@contextlib.contextmanager
def opencv_hidden():
    """``import cv2`` fails inside (as on a machine without OpenCV)."""
    saved = sys.modules.get("cv2", ...)
    sys.modules["cv2"] = None
    try:
        yield
    finally:
        if saved is ...:
            del sys.modules["cv2"]
        else:
            sys.modules["cv2"] = saved


def opencv_endpoints(port, p1, p2, served) -> dict:
    """/interpolate and /evaluate-interpolation. Without OpenCV (the card's
    machine, or OpenCV hidden where it is installed): 500 with a detail
    that names it, and the server keeps serving. Where it is installed,
    first the real answers: an MP4, and three methods' metrics."""
    out = {"opencv_installed": has_module("cv2")}
    if out["opencv_installed"]:
        answers = opencv_requests(port, p1, p2)
        status, headers, _, launches = answers["/interpolate"]
        assert status == 200 and headers["Content-Type"] == "video/mp4"
        out["interpolate"] = {"status": status, "launches": launches}
        serve_launch_check("/interpolate", launches, dict(refine_head=3))
        status, _, blob, launches = answers["/evaluate-interpolation"]
        assert status == 200, (status, blob[:300])
        out["evaluate"] = {"status": status, "launches": launches,
                           "metrics": json.loads(blob)["metrics_by_method"]}
        serve_launch_check("/evaluate-interpolation", launches,
                           dict(refine_head=1, ssim_eval=3))
        served += 2
    with opencv_hidden():
        answers = opencv_requests(port, p1, p2)
    # /interpolate refuses before the card; /evaluate-interpolation runs
    # the U-Net prediction first, as JAX's does
    for path, key, want in (("/interpolate", "interpolate_no_opencv", {}),
                            ("/evaluate-interpolation",
                             "evaluate_no_opencv", dict(refine_head=1))):
        status, _, blob, launches = answers[path]
        detail = json.loads(blob)["detail"]
        print(f"serve: {path} without OpenCV: {status} {detail!r}",
              flush=True)
        assert status == 500 and "OpenCV" in detail, (status, detail)
        serve_launch_check(f"{path} without OpenCV", launches, want)
        out[key] = {"status": status, "detail": detail, "launches": launches}
    status, _, blob = http_call(port, "GET", "/health")
    health = json.loads(blob)
    assert status == 200 and health["requests_served"] == served, health
    out["health_after"] = health
    return out


def asgi_routes(engine) -> dict:
    """``make_fastapi_app``'s routes where fastapi is installed; its
    ``ImportError`` naming the stdlib server where it is not."""
    from ai_based_frame_interpolation_torch.serve.asgi import make_fastapi_app

    if not has_module("fastapi"):
        try:
            make_fastapi_app(engine)
        except ImportError as e:
            assert "serve.server.Server" in str(e), e
            return {"fastapi": False}
        raise AssertionError("make_fastapi_app built without fastapi")
    app = make_fastapi_app(engine, resolution=SERVE_HW)
    routes = sorted(getattr(r, "path", "") for r in app.routes)
    want = {"/", "/health", "/model-info", "/interpolate",
            "/interpolate-video"}
    print(f"serve: make_fastapi_app routes {routes}", flush=True)
    assert want <= set(routes), routes
    return {"fastapi": True, "routes": routes}


def time_png_codec(h, w, iters=50) -> dict:
    """Host ms of the port's PNG decode and encode of one gray frame."""
    from ai_based_frame_interpolation_torch.ops.png import (
        decode_png, encode_png)

    img = frames(1, h, w, seed=9)[0][0]
    data = encode_png(img)
    t0 = time.perf_counter()
    for _ in range(iters):
        decode_png(data)
    dec = (time.perf_counter() - t0) * 1e3 / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        encode_png(img)
    enc = (time.perf_counter() - t0) * 1e3 / iters
    return {"decode_ms": dec, "encode_ms": enc, "png_bytes": len(data)}


def serve_path(record, unet, flow, smi) -> dict:
    """Phase 9 (module docstring): the HTTP server over the batcher."""
    from ai_based_frame_interpolation_torch.config import ServeConfig
    from ai_based_frame_interpolation_torch.models.unet import (
        count_parameters)
    from ai_based_frame_interpolation_torch.ops.image import resize_uint8
    from ai_based_frame_interpolation_torch.serve.server import (
        Server, warmup)

    out = {"hw": list(SERVE_HW)}
    cfg = ServeConfig(host="127.0.0.1", port=0)
    out["warmup_s"] = {"unet": warmup(unet, SERVE_HW),
                       "flow": warmup(flow, SERVE_HW)}
    srv = Server(unet, cfg, resolution=SERVE_HW).start_background()
    fsrv = Server(flow, cfg, resolution=SERVE_HW).start_background()
    try:
        port, batcher = srv.port, srv.service.batcher
        for path in ("/", "/health", "/model-info"):
            status, _, blob = http_call(port, "GET", path)
            assert status == 200, (path, status, blob[:300])
        info = json.loads(blob)
        assert info["parameters"] == count_parameters(unet.model) and \
            info["compute_dtype"] == "bfloat16" and \
            info["resolution"] == list(SERVE_HW), info
        health = json.loads(http_call(port, "GET", "/health")[2])
        assert health["backend"] == unet.device.type == "cuda", health
        served = 0

        # num_intermediate 1 and 3, held against the engine
        f1, f2, p1, p2 = png_frames(*SERVE_HW, seed=11)
        for num, per_dispatch, bound in ((1, 1, 1), (3, 3, BISECT_LSB)):
            reset_counts()
            got = post_frames(port, p1, p2, num_intermediate=num)
            served += 1
            launches = serve_launch_check(f"num_intermediate={num}",
                                          main_counts(),
                                          dict(refine_head=per_dispatch))
            want = unet.generate_intermediate_frames(f1, f2, num)
            du = max_lsb(got, want)
            print(f"serve: /interpolate-frames num_intermediate={num}: "
                  f"{len(got)} frames, max uint8 diff vs the engine {du} "
                  f"(bound {bound})", flush=True)
            assert len(got) == num and du <= bound
            out[f"frames_n{num}"] = {"max_uint8_diff_vs_engine": du,
                                     "launches": launches}

        # 8 concurrent requests: the batcher fuses them
        pairs = [png_frames(*SERVE_HW, seed=20 + i) for i in range(8)]
        before = dict(batcher.stats)
        reset_counts()
        answers, _ = concurrent_requests(port, pairs, 1, 1)
        served += 8
        stats = batcher.stats
        dispatches = stats["dispatches"] - before["dispatches"]
        launches = serve_launch_check("8 concurrent", main_counts(),
                                      dict(refine_head=dispatches))
        du = max(max_lsb(a, unet.generate_intermediate_frames(q[0], q[1], 1))
                 for a, q in zip(answers, pairs))
        print(f"serve: 8 concurrent requests in {dispatches} dispatches, "
              f"batcher {stats}; max uint8 diff vs the engine one pair a "
              f"call {du}", flush=True)
        assert stats["max_batch_seen"] > 1 and du <= 1
        out["concurrent"] = {"dispatches": dispatches, "batcher": stats,
                             "max_uint8_diff_vs_engine": du,
                             "launches": launches}

        # an upload at another size: the server resizes it
        g1, g2 = frames(1, 200, 300, seed=13)
        from ai_based_frame_interpolation_torch.ops.png import encode_png

        reset_counts()
        got = post_frames(port, encode_png(g1[0]), encode_png(g2[0]),
                          num_intermediate=1)
        served += 1
        launches = serve_launch_check("300x200 upload", main_counts(),
                                      dict(refine_head=1))
        want = unet.generate_intermediate_frames(
            resize_uint8(g1[0], SERVE_HW), resize_uint8(g2[0], SERVE_HW), 1)
        du = max_lsb(got, want)
        print(f"serve: a 300x200 upload resized to {SERVE_HW}: "
              f"{got[0].shape}, max uint8 diff vs the engine {du}",
              flush=True)
        assert got[0].shape == (*SERVE_HW, 1) and du <= 1
        out["resized_upload"] = {"max_uint8_diff_vs_engine": du,
                                 "launches": launches}

        # the flow server at exact times
        reset_counts()
        times = [0.25, 0.6]
        got = post_frames(fsrv.port, p1, p2,
                          times=",".join(str(t) for t in times))
        launches = serve_launch_check("flow times", main_counts(),
                                      dict(refine_head=2, sample_fused=2))
        du = max_lsb(got, flow.interpolate_at(f1, f2, times))
        print(f"serve: flow server /interpolate-frames times={times}: max "
              f"uint8 diff vs interpolate_at {du}", flush=True)
        assert len(got) == 2 and du <= 1
        out["flow_times"] = {"max_uint8_diff_vs_engine": du,
                             "launches": launches}

        out["opencv_endpoints"] = opencv_endpoints(port, p1, p2, served)
        out["asgi"] = asgi_routes(unet)

        # timings (host clock, after warmup), counts read after each group:
        # the server at 1 and 3 in-betweens; then at 1 in-between with
        # TCP_NODELAY on the server's sockets, and on the client's too; the
        # service called in-process (no HTTP) on this thread and on a fresh
        # thread a call; then the server again
        handler = srv.httpd.RequestHandlerClass
        runs = (("n1", 1, False, False), ("n3", 3, False, False),
                ("n1_server_nodelay", 1, True, False),
                ("n1_both_nodelay", 1, True, True),
                ("n1_in_process", 1, "main", False),
                ("n1_in_process_fresh_thread", 1, "fresh", False),
                ("n1_again", 1, False, False))
        for key, num, server_nodelay, client_nodelay in runs:
            before = batcher.stats["dispatches"]
            reset_counts()
            if server_nodelay in ("main", "fresh"):
                lat = time_service(srv.service, p1, p2, num, SERVE_TIMED,
                                   fresh_thread=server_nodelay == "fresh")
            else:
                handler.disable_nagle_algorithm = server_nodelay
                lat = time_requests(port, p1, p2, num, SERVE_TIMED,
                                    nodelay=client_nodelay)
            handler.disable_nagle_algorithm = False
            dispatches = batcher.stats["dispatches"] - before
            assert dispatches == SERVE_TIMED, dispatches
            out[f"latency_{key}"] = dict(latency(lat), launches=(
                serve_launch_check(f"timed {key}", main_counts(),
                                   dict(refine_head=dispatches * num))))
        before = dict(batcher.stats)
        reset_counts()
        _, wall = concurrent_requests(port, pairs, 1, SERVE_CLIENT_REQUESTS)
        n_req = SERVE_CLIENTS * SERVE_CLIENT_REQUESTS
        dispatches = batcher.stats["dispatches"] - before["dispatches"]
        out["concurrent_timed"] = {
            "clients": SERVE_CLIENTS, "requests": n_req, "seconds": wall,
            "requests_per_s": n_req / wall,
            "avg_batch": n_req / dispatches,
            "launches": serve_launch_check("timed 8 clients", main_counts(),
                                           dict(refine_head=dispatches))}
        prof = profile_call(lambda: post_frames(port, p1, p2,
                                                num_intermediate=1))
        reset_counts()
        out["profiled_request"] = {k: prof[k] for k in (
            "profiled_ms", "device_busy_ms", "device_busy_share",
            "device_kernels")}
        out["png_256"] = time_png_codec(*SERVE_HW)
        # a thread's first PyTorch work on the card: the engine alone
        for key, fresh in (("engine_main_thread", False),
                           ("engine_fresh_thread", True)):
            out[key] = latency(engine_ms(unet, f1, f2, SERVE_TIMED, fresh))
        # the transport alone: a request's and an answer's bytes at 1
        # in-between (two PNGs up, one base64 PNG down) without HTTP
        body, _ = multipart(dict(frame1=("a.png", "image/png", p1),
                                 frame2=("b.png", "image/png", p2),
                                 num_intermediate=1))
        down = len(json.dumps({"frames": ["x" * (4 * len(p1) // 3)]}))
        out["loopback"] = {"up_bytes": len(body), "down_bytes": down}
        for key, unix in (("tcp", False), ("unix", True)):
            out["loopback"][key] = latency(loopback_ms(len(body), down,
                                                       SERVE_TIMED, unix))
    finally:
        srv.shutdown()
        fsrv.shutdown()
    l1, l3, c = out["latency_n1"], out["latency_n3"], out["concurrent_timed"]
    print(f"[{smi}] serve latency at 1 in-between, p50/p95 ms: "
          + "; ".join(f"{k} {out['latency_' + k]['p50_ms']:.3f}/"
                      f"{out['latency_' + k]['p95_ms']:.3f}"
                      for k, *_ in runs), flush=True)
    p = out["profiled_request"]
    share = ("not recorded" if p["device_busy_share"] is None
             else f"{100 * p['device_busy_share']:.2f}%")
    print(f"[{smi}] serve (HTTP /interpolate-frames, {SERVE_HW[0]}x"
          f"{SERVE_HW[1]} gray, production U-Net, bf16, one client): "
          f"1 in-between p50 {l1['p50_ms']:.3f} ms p95 {l1['p95_ms']:.3f} "
          f"ms; 3 in-betweens p50 {l3['p50_ms']:.3f} ms p95 "
          f"{l3['p95_ms']:.3f} ms ({SERVE_TIMED} requests each, with the "
          f"client's decode); "
          f"{SERVE_CLIENTS} clients {c['requests_per_s']:.3f} requests/s "
          f"(avg batch {c['avg_batch']:.3f}); device busy {share} of a "
          f"profiled request of {p['profiled_ms']:.3f} ms; host PNG decode "
          f"{out['png_256']['decode_ms']:.3f} ms, encode "
          f"{out['png_256']['encode_ms']:.3f} ms a frame; a raw round trip "
          f"of the same bytes ({out['loopback']['up_bytes']} up, "
          f"{out['loopback']['down_bytes']} down) p50 "
          f"{out['loopback']['tcp']['p50_ms']:.3f} ms over TCP on "
          f"127.0.0.1, {out['loopback']['unix']['p50_ms']:.3f} ms over a "
          f"Unix socket pair; the engine alone p50 "
          f"{out['engine_main_thread']['p50_ms']:.3f} ms on one thread, "
          f"{out['engine_fresh_thread']['p50_ms']:.3f} ms on a new thread a "
          f"call", flush=True)
    record["serve"] = out
    return out


def cli_main(argv) -> tuple:
    """(exit code, stdout) of ``cli.main(argv)`` in this process."""
    import io

    from ai_based_frame_interpolation_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"cli {argv[0]}: {line}", flush=True)
    return rc, text


def serve_subprocess(export, timeout=180) -> dict:
    """``python3 -m ai_based_frame_interpolation_torch serve`` on port 0:
    read its "serving on" line, send /interpolate-frames and /health, stop
    it with SIGTERM; it must exit 0."""
    import signal

    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "ai_based_frame_interpolation_torch",
           "serve", "--host", "127.0.0.1", "--port", "0", "--model", export,
           "--height", str(SERVE_HW[0]), "--width", str(SERVE_HW[1])]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    lines, found = [], []

    def read():
        for line in proc.stdout:
            lines.append(line.rstrip())
            m = re.search(r"serving on http://127\.0\.0\.1:(\d+)", line)
            if m and not found:
                found.append(int(m.group(1)))

    reader = threading.Thread(target=read, daemon=True)
    reader.start()
    try:
        while not found and proc.poll() is None and \
                time.perf_counter() - t0 < timeout:
            time.sleep(0.1)
        assert found, f"no 'serving on' line: {lines}"
        start_s = time.perf_counter() - t0
        port = found[0]
        f1, f2, p1, p2 = png_frames(*SERVE_HW, seed=31)
        got = post_frames(port, p1, p2, num_intermediate=1)
        assert len(got) == 1 and got[0].shape == (*SERVE_HW, 1)
        status, _, blob = http_call(port, "GET", "/health")
        health = json.loads(blob)
        assert status == 200 and health["requests_served"] == 1 and \
            health["backend"] == "cuda", health
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        reader.join(timeout=10)
    for line in lines:
        print(f"cli serve (subprocess): {line}", flush=True)
    print(f"cli serve (subprocess): serving after {start_s:.3f} s, exit "
          f"code {rc} after SIGTERM", flush=True)
    assert rc == 0, rc
    return {"serving_after_s": start_s, "exit_code": rc, "health": health}


def cli_path(record, export, smi) -> dict:
    """Phase 10 (module docstring): the port's command line."""
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.ops.image import (
        load_image, save_image)
    from ai_based_frame_interpolation_torch.train.checkpoint import (
        export_pth)

    out = {}
    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        rc, _ = cli_main(["dataset", "--output-dir", data, "--videos", "2",
                          "--size", str(SERVE_HW[0])])
        clips = sorted(os.listdir(data))
        assert rc == 0 and len(clips) == 2 and all(
            len(os.listdir(os.path.join(data, c))) == 16 for c in clips)

        rc, text = cli_main(["info", "--model", export])
        assert rc == 0 and "epochs completed: 2" in text, text

        f1, f2 = frames(1, *SERVE_HW, seed=41)
        a, b = os.path.join(root, "a.png"), os.path.join(root, "b.png")
        save_image(a, f1[0])
        save_image(b, f2[0])
        mid = os.path.join(root, "mid.png")
        reset_counts()
        size = ["--height", str(SERVE_HW[0]), "--width", str(SERVE_HW[1])]
        rc, _ = cli_main(["infer", "--frame1", a, "--frame2", b, "--model",
                          export, "--num-intermediate", "1", "--output",
                          mid] + size)
        launches = main_counts()
        assert rc == 0 and launches == dict(NO_LAUNCHES, refine_head=1), \
            launches
        want = InterpolationEngine.from_checkpoint(export).interpolate_pair(
            f1[0], f2[0])
        du = max_lsb([load_image(mid)], [want])
        print(f"cli infer on the export: max uint8 diff vs its engine {du}; "
              f"launches {launches}", flush=True)
        assert du <= 1
        out["infer_export"] = {"max_uint8_diff_vs_engine": du,
                               "launches": launches}

        # the reference config's .pth -> export directory -> .pth, bit for
        # bit, then infer on it (no head: no kernel)
        model = train_model_of({}, 43)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(44)
            for name, buf in model.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
                elif name.endswith("running_var"):
                    buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
        ref = export_pth(os.path.join(root, "ref.pth"), model.state_dict(),
                         ModelConfig())
        conv = os.path.join(root, "converted")
        back = os.path.join(root, "back.pth")
        assert cli_main(["convert", "--input", ref, "--output", conv])[0] == 0
        assert cli_main(["convert", "--input", conv, "--output", back])[0] \
            == 0
        sd0 = torch.load(ref, weights_only=False)["model_state_dict"]
        sd1 = torch.load(back, weights_only=False)["model_state_dict"]
        assert list(sd0) == list(sd1) and all(
            torch.equal(sd0[k], sd1[k]) for k in sd0)
        print(f"cli convert: .pth -> export -> .pth, {len(sd0)} arrays bit "
              "for bit", flush=True)
        reset_counts()
        rc, _ = cli_main(["infer", "--frame1", a, "--frame2", b, "--model",
                          ref, "--output", mid] + size)
        launches = main_counts()
        assert rc == 0 and launches == NO_LAUNCHES, launches
        want = InterpolationEngine.from_checkpoint(ref).interpolate_pair(
            f1[0], f2[0])
        du = max_lsb([load_image(mid)], [want])
        assert du <= 1
        out["convert"] = {"arrays": len(sd0), "infer_max_uint8_diff": du}
    out["serve_subprocess"] = serve_subprocess(export)
    record["cli"] = out
    return out


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
    # host modules the port's optional paths use (OpenCV: the MP4s, the
    # Farneback baseline, non-PNG uploads; matplotlib: eval's plots)
    import importlib.util

    record["host_modules"] = {m: importlib.util.find_spec(m) is not None
                              for m in ("cv2", "matplotlib", "PIL",
                                        "pandas", "fastapi")}
    print(f"host modules: {record['host_modules']}", flush=True)

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
    video, video_routes = video_path(record, unet, flow, smi)   # 7.
    keep = tempfile.TemporaryDirectory()       # phase 8's export, for 10
    train = train_path(record, smi, os.path.join(keep.name, "ckpt"))  # 8.
    val_launches = train["train_model"]["launches"]
    flow_val = train["flow_validation_launches"]
    serve = serve_path(record, unet, flow, smi)                 # 9.
    cli = cli_path(record, train["export"]["dir"], smi)         # 10.
    keep.cleanup()
    # the kernels' launches over phases 9 and 10 (each group counted)
    served = collections.Counter()
    groups = [v["launches"] for k, v in serve.items()
              if isinstance(v, dict) and "launches" in v
              and k != "flow_times"]
    groups += [v["launches"] for v in serve["opencv_endpoints"].values()
               if isinstance(v, dict) and "launches" in v]
    groups.append(cli["infer_export"]["launches"])
    for g in groups:
        served["refine_head_w64"] += g["refine_head"]
        served["ssim_eval"] += g["ssim_eval"]
    flow_served = serve["flow_times"]["launches"]
    served["refine_head_w16"] += flow_served["refine_head"]
    served["sample_fused"] += flow_served["sample_fused"]
    record["serve_cli_launches"] = dict(served)

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
    video["unet_2x"]["bare"] = timings["unet_b8"]
    for key, run in video.items():
        st, bare = run["stream"], run["bare"]
        run["stream_over_bare"] = st["output_fps"] / bare["output_fps"]
        share = st["device_busy_share"]
        print(f"[{smi}] video {key}: stream {st['output_fps']:.3f} output "
              f"fps; bare b8 {bare['output_fps']:.3f}; stream/bare "
              f"{run['stream_over_bare']:.4f}; device busy "
              f"{'not recorded' if share is None else f'{100 * share:.2f}%'} "
              f"of a profiled stream run", flush=True)
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
    # 11. the model options, after 5 freed the other engines
    options = options_path(record, smi, timings["flow_b8"]["output_fps"])
    parallel = parallel_path(record, smi)                       # 12.
    dp_launches = collections.Counter(parallel["launches"])
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
             unet_launches["refine_head"]
             + video_routes["refine_head w64/w64/bfloat16"]
             + val_launches["refine_head"]
             + train["export"]["launches"]["refine_head"]
             + served["refine_head_w64"]
             + options["launches"]["refine_head_w64"]
             + dp_launches["refine_head_w64"],
             record["refine_head_w64_max_abs_err"],
             "refine_head_w64_1088x1920"),
            ("refine_head_w16", "refine_head.cu", "refine_fused.py:417",
             flow_launches["refine_head"]
             + video_routes["refine_head w16/w16/bfloat16"]
             + flow_val["refine_head"] + served["refine_head_w16"]
             + options["launches"]["refine_head_w16"]
             + dp_launches["refine_head_w16"],
             record["refine_head_w16_max_abs_err"],
             "refine_head_w16_1088x1920"),
            ("sample_fused", "sample_fused.cu", "warp_fused.py:183",
             flow_launches["sample_fused"]
             + video["flow_retime_2.5"]["launches"]["sample_fused"]
             + flow_val["sample_fused"] + served["sample_fused"]
             + options["launches"]["sample_fused"]
             + dp_launches["sample_fused"],
             record["sample_fused_max_abs_err"], "sample_fused_1088x1920"),
            ("ssim_eval_256", "ssim_eval.cu", "ssim_fused.py:63",
             evals["unet_256"]["launches"]["ssim_eval"]
             + val_launches["ssim_eval"] + flow_val["ssim_eval"]
             + served["ssim_eval"] + dp_launches["ssim_eval"],
             ssim_errs["8x256x256"], "ssim_eval_8x256x256"),
            ("ssim_eval_1080", "ssim_eval.cu", "ssim_fused.py:169",
             evals["unet_1080"]["launches"]["ssim_eval"],
             ssim_errs["8x1080x1920"], "ssim_eval_8x1080x1920"),
            ("double_conv", "double_conv.cu", "dconv_fused.py:164",
             core_launches["double_conv"] + dp_launches["double_conv"],
             record["double_conv_max_abs_err"], "double_conv_b8"),
            ("up_double_conv", "double_conv.cu", "dconv_fused.py:411",
             core_launches["up_double_conv"] + dp_launches["up_double_conv"],
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
