"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port only (it imports nothing of JAX or of the JAX package):

1. prints the card (``nvidia-smi`` name and power limit), builds every CUDA
   source of the package for sm_90a and prints the build time;
2. holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes and a few more;
3. drives the main path once: the full-width production U-Net engine
   (s2d 4, base 64, depth 4, residual, refinement head 64, half-pixel
   decoder, random weights from a seed) on a batch of 8 gray 1080p frame
   pairs, with every kernel's launch count set to 0 just before and read
   just after, and checks the output against the same port modules composed
   with the plain head;
4. answers concurrent requests through the port's batcher;
5. times the engine and each kernel with CUDA events.

Any failure raises and exits non-zero. It prints the kernel record as one
JSON line before the last, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
after a ``record {...}`` line with every number it measured.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

H100_BF16_FLOPS = 989e12       # dense bf16 tensor-core peak, FLOP/s
H100_HBM_BYTES = 3.35e12       # HBM3 bandwidth, B/s
FLOAT_BOUND = 0.032            # 2 bf16 ulp at |x| < 4 (see check_kernel)
PROD = dict(space_to_depth=4, residual=True, refine_width=64,
            upsample="half_pixel")


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def head_inputs(b, h, w, c, nextra, width=64, seed=0):
    """Random head inputs and weights (PyTorch layouts) on the card."""
    gen = torch.Generator().manual_seed(seed)
    nplanes = (1 + nextra) * c

    def conv(cin, cout, k):
        wt = torch.randn(cout, cin, k, k, generator=gen) / (k * k * cin) ** 0.5
        return {"weight": wt.cuda(), "bias": (0.1 * torch.randn(
            cout, generator=gen)).cuda()}

    params = {"refine1": conv(nplanes, width, 3),
              "refine2": conv(width, width, 3),
              "refine_out": conv(width, c, 1)}
    y = (torch.rand(b, h, w, c, generator=gen) * 2 - 1).cuda()
    planes = [(torch.rand(b, h, w, c, generator=gen) * 2 - 1).to(
        torch.bfloat16).cuda() for _ in range(nextra)]
    return y, planes, params


def check_kernel(shape) -> float:
    """The refine_head kernel vs its plain version on the card: within
    FLOAT_BOUND (both round each conv to bf16 around its bias; f32 sums in
    another order can flip a value on a rounding boundary by one ulp, which
    the next conv carries) and within 1 uint8 LSB after denormalize."""
    from ai_based_frame_interpolation_torch.ops.image import (
        denormalize_to_uint8)
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head, refine_head_reference)

    b, h, w, c, nextra = shape
    y, planes, params = head_inputs(b, h, w, c, nextra)
    before = refine_head.launches
    got = refine_head(y, planes, params)
    torch.cuda.synchronize()
    assert refine_head.launches == before + 1, "refine_head did not launch"
    want = refine_head_reference(y, planes, params)
    err = float((got.float() - want.float()).abs().max())
    du = (denormalize_to_uint8(got).int() - denormalize_to_uint8(want).int()).abs()
    print(f"refine_head B={b} {h}x{w} C={c} planes={(1 + nextra) * c}: "
          f"max|kernel-plain|={err:.6g} uint8 differing={float((du > 0).float().mean()):.6g}"
          f" max uint8 diff={int(du.max())}", flush=True)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert bool(torch.isfinite(got.float()).all())
    assert err <= FLOAT_BOUND, f"kernel disagrees by {err}"
    assert int(du.max()) <= 1, f"kernel disagrees by {int(du.max())} LSB"
    return err


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


def reference_midpoints(engine, f1, f2) -> torch.Tensor:
    """The engine's 2x path composed from the same port modules with the
    plain refinement head, for the check only."""
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
        y = model(x1, x2, skip_refine=True)
        out = refine_head_reference(
            y.permute(0, 2, 3, 1), (x1.permute(0, 2, 3, 1),
                                    x2.permute(0, 2, 3, 1)),
            model.head_params(), cdt).permute(0, 3, 1, 2)
        return denormalize_to_uint8(crop_to(out, hw)).permute(0, 2, 3, 1)


def head_flops_bytes(b, h, w, c, nplanes, width=64):
    px = b * h * w
    flops = 2 * px * (9 * nplanes * width + 9 * width * width + width * c)
    weights = 2 * (9 * nplanes * width + width + 9 * width * width + width) \
        + 4 * (width * c + c)
    byts = px * (4 * c + 2 * (nplanes - c) + 2 * c) + weights
    return flops, byts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.ops import _build
    from ai_based_frame_interpolation_torch.ops.refine import (
        refine_head, refine_head_reference)
    from ai_based_frame_interpolation_torch.serve.batcher import (
        DynamicBatcher)

    t_start = time.perf_counter()
    smi = card()
    kind = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}",
          flush=True)
    record = {"card": smi, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    # 1. build every kernel source, one nvcc each, all at once
    t0 = time.perf_counter()
    _build.build()
    record["build_s"] = time.perf_counter() - t0
    print(f"kernel build {record['build_s']:.1f} s "
          f"({', '.join(_build.sources())})", flush=True)
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # 2. each kernel against its plain version on the card
    # the main path's shapes (8x1088x1920; the batcher's 4x256x256), one
    # 1080p frame, widths 128/256, heights that are not a multiple of 16,
    # RGB (9 planes) and 5 planes
    shapes = [(8, 1088, 1920, 1, 2), (4, 256, 256, 1, 2), (1, 1088, 1920, 1, 2),
              (2, 72, 128, 1, 2), (2, 40, 256, 1, 2), (1, 40, 72, 3, 2),
              (2, 56, 96, 1, 4)]
    errs = [check_kernel(s) for s in shapes]
    record["refine_head_max_abs_err"] = max(errs)

    # 3. the main path: full-width production engine, 1080p gray 2x, b=8
    engine = InterpolationEngine.random_init(ModelConfig(**PROD), seed=0)
    f1, f2 = frames(8, 1080, 1920, seed=1)
    refine_head.launches = 0
    t0 = time.perf_counter()
    out = engine.interpolate_batch(f1, f2)
    main_s = time.perf_counter() - t0
    launches = refine_head.launches
    print(f"main path: interpolate_batch b=8 1080x1920 -> {out.shape} "
          f"{out.dtype} in {main_s:.3f} s (first call); refine_head "
          f"launches {launches}", flush=True)
    assert launches > 0, "the main path did not run the refine_head kernel"
    assert out.shape == (8, 1080, 1920, 1) and out.dtype == np.uint8
    want = reference_midpoints(engine, f1, f2).cpu().numpy()
    du = np.abs(out.astype(np.int16) - want.astype(np.int16))
    print(f"main path vs plain head: max uint8 diff {int(du.max())}, "
          f"differing {float((du > 0).mean()):.6g}, mean output "
          f"{float(out.mean()):.3f}", flush=True)
    assert int(du.max()) <= 1
    record["main_path"] = {"batch": 8, "hw": [1080, 1920],
                           "refine_head_launches": launches,
                           "max_uint8_diff_vs_plain": int(du.max()),
                           "uint8_differing_share": float((du > 0).mean())}

    # 4. concurrent requests through the batcher at the serve default size
    batcher = DynamicBatcher(engine, max_batch=8)
    r1, r2 = frames(8, 256, 256, seed=2)
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

    refine_head.launches = 0
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
    print(f"requests: 8 answered, batcher {batcher.stats}, refine_head "
          f"launches {refine_head.launches}", flush=True)
    assert refine_head.launches > 0
    record["requests"] = dict(batcher.stats,
                              refine_head_launches=refine_head.launches)

    # 5. timings (CUDA events, after warm-up)
    timings = {}
    fn = engine._pair_fn(1, 1)
    for b, iters in ((8, 10), (32, 4)):
        g1, g2 = frames(b, 1080, 1920, seed=3)
        d1, d2 = engine._put(g1), engine._put(g2)
        ms = cuda_ms(lambda: fn(engine.model, d1, d2), iters, warmup=1)
        pairs_s = b / (ms / 1e3)
        timings[f"engine_b{b}"] = {"ms_per_call": ms,
                                   "midpoints_per_s": pairs_s,
                                   "output_fps": 2 * pairs_s}
        print(f"[{smi}] engine 1080p gray 2x b={b}: {ms:.3f} ms/call, "
              f"{pairs_s:.3f} midpoints/s, {2 * pairs_s:.3f} output fps",
              flush=True)
        del d1, d2

    b, h, w, c, nextra = 1, 1088, 1920, 1, 2
    y, planes, params = head_inputs(b, h, w, c, nextra)
    k_ms = cuda_ms(lambda: refine_head(y, planes, params), 10)
    p_ms = cuda_ms(lambda: refine_head_reference(y, planes, params), 10)
    cl = torch.channels_last
    pred = y.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    z0 = torch.cat([pred.to(torch.bfloat16)] + [
        p.permute(0, 3, 1, 2) for p in planes], 1).contiguous(memory_format=cl)
    lw = {n: {"weight": p["weight"].to(torch.bfloat16).contiguous(
        memory_format=cl), "bias": p["bias"].to(torch.bfloat16)}
        for n, p in params.items()}
    f = torch.nn.functional

    def library():
        z = f.relu(f.conv2d(z0, lw["refine1"]["weight"],
                            lw["refine1"]["bias"], padding=1))
        z = f.relu(f.conv2d(z, lw["refine2"]["weight"],
                            lw["refine2"]["bias"], padding=1))
        return pred + f.conv2d(z, lw["refine_out"]["weight"],
                               lw["refine_out"]["bias"])

    l_ms = cuda_ms(library, 10)
    flops, byts = head_flops_bytes(b, h, w, c, (1 + nextra) * c)
    t_ops, t_bytes = flops / H100_BF16_FLOPS, byts / H100_HBM_BYTES
    bound_ms = max(t_ops, t_bytes) * 1e3
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    print(f"[{smi}] refine_head 1x1088x1920 gray 3 planes w64: kernel "
          f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, library (cuDNN bf16 "
          f"channels_last convs) {l_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}: {flops / 1e9:.2f} GFLOP, {byts / 1e6:.2f} MB)",
          flush=True)
    timings["refine_head_1088x1920"] = {"ms": k_ms, "plain_ms": p_ms,
                                        "library_ms": l_ms,
                                        "bound_ms": bound_ms,
                                        "bound_by": bound_by,
                                        "flops": flops, "bytes": byts}
    record["timings"] = timings
    record["seconds"] = time.perf_counter() - t_start

    kernels = [{"name": "refine_head", "route": "cuda",
                "source": "ai_based_frame_interpolation_torch/csrc/refine_head.cu",
                "replaces": "ai_based_frame_interpolation_tpu/ops/pallas/"
                            "refine_fused.py:417",
                "launches": launches,
                "max_abs_err": record["refine_head_max_abs_err"],
                "ms": k_ms, "plain_ms": p_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": l_ms}]
    print("record " + json.dumps(record), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
