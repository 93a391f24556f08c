"""Where the port's engine spends device time: a torch.profiler window.

    python3 scripts/torch_profile_engine.py [--arch unet|flow] [--batch 8]
                                           [--calls 3] [--core-impl xla]
                                           [--depthwise] [--dtype float32]
                                           [--core-pack 2] [--polyphase]
                                           [--flow-bidir] [--flow-cascade 1]
                                           [--warp-impl pyramid]

Runs a production engine of the PyTorch port (random weights from seed 0)
on gray 1080p 2x batches on the CUDA card, profiles a few warm calls, and
prints the device time by kernel name and the device's busy share of the
window, then the same as one JSON line. ``--arch unet`` is the production
U-Net (s2d 4, base 64, head 64); ``--arch flow`` the flow production
config (base 32, flow_scale 4, head 16, shifts warp, max_flow 16). For the
U-Net, ``--core-impl`` is the engine's ``core_impl`` (``pallas``: the
option core), ``--depthwise`` selects the depthwise head, ``--core-pack``
is the engine's ``core_pack`` and ``--polyphase`` turns
``models/unet.py:UP_POLYPHASE`` on. For the flow family, ``--flow-bidir``,
``--flow-cascade`` and ``--warp-impl`` are the model options (the
cascade's out convs drawn, std 0.01, as ``chip_smoke.drawn_cascade``
does). ``--dtype``
is the engine's compute dtype; ``float32`` runs with TF32 off (cuDNN's f32
convs use TF32 by default, which is not an f32 computation). Needs a CUDA
card; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", choices=("unet", "flow"), default="unet")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--calls", type=int, default=3)
    p.add_argument("--core-impl", choices=("xla", "auto", "pallas"),
                   default="xla")
    p.add_argument("--depthwise", action="store_true")
    p.add_argument("--dtype", choices=("bfloat16", "float32"),
                   default="bfloat16")
    p.add_argument("--core-pack", type=int, default=1)
    p.add_argument("--polyphase", action="store_true")
    p.add_argument("--flow-bidir", action="store_true")
    p.add_argument("--flow-cascade", type=int, default=0)
    p.add_argument("--warp-impl", default="shifts",
                   choices=("shifts", "pyramid", "gather4", "patch"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_profile_engine: needs a CUDA card", file=sys.stderr)
        return 2
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.models import unet as unet_mod

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    cfg = ModelConfig(space_to_depth=4, residual=True, refine_width=64,
                      upsample="half_pixel", refine_depthwise=args.depthwise) \
        if args.arch == "unet" else \
        ModelConfig(arch="flow", base_width=32, flow_scale=4, refine_width=16,
                    warp_impl=args.warp_impl, max_flow=16,
                    flow_bidir=args.flow_bidir,
                    flow_cascade=args.flow_cascade)
    dtype = getattr(torch, args.dtype)
    if dtype == torch.float32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    engine = InterpolationEngine.random_init(cfg, seed=0, compute_dtype=dtype,
                                             core_impl=args.core_impl,
                                             core_pack=args.core_pack)
    chip_smoke.drawn_cascade(engine.model, seed=5)
    unet_mod.UP_POLYPHASE = args.polyphase
    gen = np.random.default_rng(0)
    shape = (args.batch, 1080, 1920, 1)
    f1 = engine._put(gen.integers(0, 256, shape, np.uint8))
    f2 = engine._put(gen.integers(0, 256, shape, np.uint8))
    fn = engine._pair_fn(1, 1)
    for _ in range(2):
        fn(engine.model, f1, f2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.calls):
            fn(engine.model, f1, f2)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []           # device kernels only (operator rows would count twice)
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(ev, "self_device_time_total",
                         getattr(ev, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((ev.key[:120], dev_us / 1e3 / args.calls,
                         ev.count // args.calls))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    per_call = wall_ms / args.calls
    label = (f"flow warp_impl={args.warp_impl}"
             f"{' bidir' if args.flow_bidir else ''}"
             f" cascade={args.flow_cascade}") if args.arch == "flow" else (
        f"unet core_impl={args.core_impl} core_pack={args.core_pack}"
        f"{' polyphase' if args.polyphase else ''}"
        f"{' depthwise head' if args.depthwise else ''}") + (
        " f32 (TF32 off)" if dtype == torch.float32 else "")
    lines = [f"[{card}] {label} engine 1080p gray 2x b={args.batch}: "
             f"{per_call:.3f} ms "
             f"per call (host clock, {args.calls} calls), device busy "
             f"{busy:.3f} ms per call ({100 * busy / per_call:.1f}%)"]
    lines += [f"{ms:10.3f} ms {100 * ms / busy:5.1f}%  x{n:<4d} {key[:90]}"
              for key, ms, n in rows[:30]]
    if not rows:
        lines.append("profiler recorded no device time")
    print("\n".join(lines), flush=True)
    print(json.dumps({"card": card, "arch": args.arch,
                      "core_impl": args.core_impl,
                      "depthwise": args.depthwise, "dtype": args.dtype,
                      "core_pack": args.core_pack,
                      "polyphase": args.polyphase,
                      "flow_bidir": args.flow_bidir,
                      "flow_cascade": args.flow_cascade,
                      "warp_impl": args.warp_impl,
                      "batch": args.batch,
                      "ms_per_call": per_call, "device_busy_ms": busy,
                      "kernels": rows}), flush=True)
    return 0 if rows else 1


if __name__ == "__main__":
    sys.exit(main())
