"""The port's command line: train / infer / video / eval / serve / info /
demo / dataset / convert (JAX ``cli.py``).

The JAX CLI's subcommands, options, defaults and choices, run on the
port. Two differences: the program name (``fi-torch``, also ``python3 -m
ai_based_frame_interpolation_torch``), and ``--device`` on every
subcommand that runs a model (train, infer, video, eval, serve, demo),
which means what it says: the CUDA card by default, an error without one,
``--device cpu`` for the CPU. ``info`` and ``convert`` read and write
weights on the host only.

What needs OpenCV (not on the card's machine): the MP4s of ``video``,
``demo`` and ``infer --num-intermediate`` above 1, the ``optical_flow``
method of ``eval`` and ``demo``, and non-PNG images; ``eval``'s plots
need matplotlib.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

from .config import ModelConfig, ServeConfig, TrainConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fi-torch",
        description="AI frame interpolation on PyTorch and CUDA")
    sub = p.add_subparsers(dest="command", required=True)

    def add_device(sp):
        sp.add_argument("--device", default=None,
                        help="torch device the model runs on (cuda, "
                             "cuda:N or cpu; default: the CUDA card, and "
                             "an error without one)")

    def add_model_flags(sp):
        sp.add_argument("--model", default="checkpoints",
                        help="export directory (train.checkpoint.save_variables) "
                             "or reference .pth file")
        sp.add_argument("--channels", type=int, default=None, choices=(1, 3),
                        help="1=grayscale (reference parity), 3=RGB; "
                             "default: from checkpoint, else 1")
        sp.add_argument("--dtype", default="bfloat16",
                        choices=("bfloat16", "float32"),
                        help="compute dtype on device")
        sp.add_argument("--s2d", type=int, default=None, choices=(1, 2, 4, 8),
                        help="space-to-depth stem (1=reference parity; "
                             "2/4=high-res speed variants; default: from "
                             "checkpoint, else 1)")
        sp.add_argument("--refine-width", type=int, default=None,
                        help="refinement head width for s2d models "
                             "(recommended: 64 — nearly free vs 16)")
        sp.add_argument("--refine-factor", type=int, default=None,
                        help="rearrange factor the refine head runs at "
                             "(1=full res, s2d=fastest; default from "
                             "checkpoint, else 1)")
        sp.add_argument("--arch", default=None,
                        choices=("unet", "tower", "flow"),
                        help="model family (default: from checkpoint, else "
                             "unet = reference parity)")
        sp.add_argument("--upsample", default=None,
                        choices=("align_corners", "half_pixel"),
                        help="decoder upsample grid (default: from "
                             "checkpoint; align_corners = reference parity, "
                             "half_pixel = F.interpolate(align_corners=False) "
                             "grid)")
        sp.add_argument("--refine-depthwise", action="store_true",
                        help="separable refine conv2 (matches a checkpoint "
                             "trained with --refine-depthwise)")
        sp.add_argument("--base-width", type=int, default=None,
                        help="first-stage width (default: from checkpoint, "
                             "else 64 = reference parity)")
        sp.add_argument("--flow-scale", type=int, default=None,
                        help="flow family: motion backbone runs at "
                             "1/flow_scale resolution (field upsampled; "
                             "default: from checkpoint, else 1)")
        sp.add_argument("--warp-impl", default=None,
                        choices=("gather4", "patch", "shifts", "pyramid"),
                        help="flow family: backward-warp strategy. "
                             "gather4/patch are numerically identical "
                             "(checkpoint-safe to flip); shifts is the "
                             "gather-free separable path (displacements "
                             "clamped to +-max_flow px); pyramid = shifts "
                             "with a strided coarse level (full +-max_flow "
                             "range at ~sqrt cost)")
        sp.add_argument("--max-flow", type=int, default=None,
                        help="shifts/pyramid warp: per-axis displacement "
                             "bound in pixels (default 32)")
        sp.add_argument("--core-pack", type=int, default=1,
                        help="unet family, inference only: fold g batch "
                             "items into channels and run grouped convs; "
                             "identical math. Dispatches whose batch is "
                             "not a multiple of g run unpacked")
        sp.add_argument("--core-impl", default="xla",
                        choices=("xla", "auto", "pallas"),
                        help="U-Net core route: xla (default) = the "
                             "model's cuDNN convs; auto = the option core "
                             "(hand-written double-conv kernels) on the "
                             "card where it is eligible; pallas = the "
                             "option core always, an error where it is "
                             "not eligible")

    t = sub.add_parser("train", help="train the interpolation model")
    t.add_argument("--data-dir", default="data/train")
    t.add_argument("--epochs", type=int, default=100)
    t.add_argument("--batch-size", type=int, default=8)
    t.add_argument("--lr", type=float, default=1e-4,
                   help="initial learning rate (reference hardcodes 1e-4)")
    t.add_argument("--val-split", type=float, default=0.2)
    t.add_argument("--height", type=int, default=256)
    t.add_argument("--width", type=int, default=256)
    t.add_argument("--channels", type=int, default=1, choices=(1, 3))
    t.add_argument("--s2d", type=int, default=1, choices=(1, 2, 4, 8),
                   help="space-to-depth stem (1=reference parity)")
    t.add_argument("--arch", default="unet",
                   choices=("unet", "tower", "flow"),
                   help="model family: unet (reference parity) | tower "
                        "(siamese encoder; video streams reuse per-frame "
                        "features) | flow (motion-compensated: learned "
                        "flow + warp + blend; native arbitrary-time, one "
                        "backbone pass per pair at any factor; requires "
                        "--s2d 1, recommended --base-width 32)")
    t.add_argument("--residual", action="store_true",
                   help="predict the correction to the linear midpoint "
                        "(faster convergence; changes the learned function)")
    t.add_argument("--refine-width", type=int, default=0,
                   help="refinement head width for s2d models")
    t.add_argument("--refine-factor", type=int, default=1,
                   help="rearrange factor the refine head runs at "
                        "(1=full resolution, s2d=fastest)")
    t.add_argument("--upsample", default="align_corners",
                   choices=("align_corners", "half_pixel"),
                   help="decoder upsample grid: align_corners = reference "
                        "parity semantics; half_pixel = "
                        "F.interpolate(align_corners=False) grid")
    t.add_argument("--refine-depthwise", action="store_true",
                   help="separable refine conv2 (depthwise+pointwise): "
                        "much cheaper head at 1080p")
    t.add_argument("--base-width", type=int, default=64,
                   help="first-stage width (64 = reference parity)")
    t.add_argument("--flow-smooth", type=float, default=0.0,
                   help="flow family only: edge-aware smoothness weight on "
                        "the predicted motion field (0 = off; try 0.01-0.1)")
    t.add_argument("--flow-scale", type=int, default=1,
                   help="flow family only: run the motion backbone at "
                        "1/flow_scale resolution (average-pooled inputs, "
                        "bilinearly upsampled field) — the flow analog of "
                        "--s2d: ~flow_scale^2 cheaper backbone, full-res "
                        "warp/blend output")
    t.add_argument("--flow-photo", type=float, default=0.0,
                   help="flow family only: endpoint photometric field "
                        "supervision weight — L1 between each frame and "
                        "its full warp from the other frame (0 = off; "
                        "try 0.05-0.2)")
    t.add_argument("--census", type=float, default=0.0,
                   help="illumination-robust census-transform loss weight "
                        "(any family; soft census descriptor Hamming "
                        "distance, ops/census.py). 0 = off — on clean "
                        "content it costs -0.003/-0.007 SSIM at w=0.5/1.0; "
                        "on exposure-flicker content 0.5 WINS +0.007 SSIM "
                        "(docs/QUALITY.md sections 6 and 8) — use 0.5 for "
                        "footage with lighting flicker / rolling exposure")
    t.add_argument("--census-window", type=int, default=7,
                   help="census descriptor window (odd; default 7)")
    t.add_argument("--flow-cascade", type=int, default=0,
                   help="flow family: residual field-refinement stages "
                        "after the backbone (each = 2 midpoint warps + a "
                        "thin full-res conv stack emitting flow/mask "
                        "residuals, zero-initialized; RIFE-style "
                        "coarse-to-fine). 0 = off")
    t.add_argument("--flow-bidir", action="store_true",
                   help="flow family only: predict two independent motion "
                        "fields (f1->f2 and f2->f1, Super-SloMo-style "
                        "time-t warp synthesis) instead of one field and "
                        "its negation — helps occlusions / non-symmetric "
                        "motion")
    t.add_argument("--warp-impl", default="shifts",
                   choices=("gather4", "patch", "shifts", "pyramid"),
                   help="flow family only: backward-warp strategy the model "
                        "trains through. shifts (default) = gather-free "
                        "separable path (displacements clamped to "
                        "+-max_flow px, quality-equal by A/B); pyramid = "
                        "shifts with a strided coarse level (full range at "
                        "~sqrt cost); gather4 = exact bilinear warp")
    t.add_argument("--max-flow", type=int, default=32,
                   help="shifts/pyramid warp: per-axis displacement bound "
                        "in pixels (shifts cost is linear in the bound, "
                        "pyramid ~sqrt)")
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--ema-decay", type=float, default=0.0,
                   help="exponential moving average of the weights "
                        "(0 = off; try 0.999). The EMA weights are what "
                        "validation scores and what exports for inference")
    t.add_argument("--augment", action="store_true",
                   help="label-consistent train augmentation: random "
                        "horizontal/vertical flips and temporal swap")
    t.add_argument("--grad-accum", type=int, default=1,
                   help="sequential microbatches per optimizer step: same "
                        "effective batch, ~N x lower activation memory "
                        "(for resolutions/batches one chip can't hold); "
                        "batch size must divide evenly")
    t.add_argument("--save-every", type=int, default=1,
                   help="epochs between resume-point ('latest') checkpoint "
                        "writes (best-val always saves); raise on hosts "
                        "where the device->host state fetch is slow")
    t.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint (true resume: "
                        "optimizer state, epoch, LR schedule)")
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--num-devices", type=int, default=-1,
                   help="devices in the data-parallel mesh (-1 = all)")
    t.add_argument("--num-workers", type=int, default=4)
    add_device(t)

    i = sub.add_parser("infer", help="interpolate between two frames")
    i.add_argument("--frame1", required=True)
    i.add_argument("--frame2", required=True)
    add_model_flags(i)
    i.add_argument("--output", default="interpolated_frame.png")
    i.add_argument("--num-intermediate", type=int, default=1)
    i.add_argument("--fps", type=int, default=30)
    i.add_argument("--save-comparison", action="store_true",
                   help="also write a linear-blend comparison video")
    i.add_argument("--height", type=int, default=256)
    i.add_argument("--width", type=int, default=256)
    add_device(i)

    v = sub.add_parser("video", help="interpolate a video file to 2x/4x/8x fps")
    v.add_argument("--input", required=True)
    v.add_argument("--output", required=True)
    add_model_flags(v)
    v.add_argument("--factor", type=int, default=2,
                   help="frame-rate multiplier (any integer >= 2; exact for "
                        "flow/time-conditioned models and for powers of two "
                        "on bisection models, nearest-dyadic otherwise)")
    v.add_argument("--target-fps", type=float, default=None,
                   help="retime to an arbitrary output fps instead of an "
                        "integer factor (24->60 etc.; fractional rates, "
                        "originals pass through losslessly). Requires an "
                        "exact-time model: --arch flow or time-conditioned")
    v.add_argument("--fps", type=float, default=None,
                   help="output fps (default: input fps * factor)")
    v.add_argument("--batch-pairs", type=int, default=8)
    add_device(v)

    e = sub.add_parser("eval", help="evaluate vs linear + optical-flow baselines")
    e.add_argument("--test-dir", required=True)
    add_model_flags(e)
    e.add_argument("--output-dir", default="evaluation_results")
    e.add_argument("--batch-size", type=int, default=8)
    e.add_argument("--height", type=int, default=256)
    e.add_argument("--width", type=int, default=256)
    e.add_argument("--max-triplets", type=int, default=None)
    e.add_argument("--save-frames", action="store_true")
    add_device(e)

    s = sub.add_parser("serve", help="start the HTTP API")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    add_model_flags(s)
    s.add_argument("--height", type=int, default=256)
    s.add_argument("--width", type=int, default=256)
    s.add_argument("--no-warmup", action="store_true")
    add_device(s)

    n = sub.add_parser("info", help="model / checkpoint information")
    add_model_flags(n)

    d = sub.add_parser("demo", help="generate fixtures and smoke-run every "
                                    "component (reference demo_simple.py)")
    d.add_argument("--output-dir", default="test_data")
    d.add_argument("--size", type=int, default=128)
    add_device(d)

    ds = sub.add_parser("dataset", help="generate a procedural training "
                                        "dataset (textured panning scenes "
                                        "with multiple moving sprites)")
    ds.add_argument("--output-dir", default="data/train")
    ds.add_argument("--videos", type=int, default=64)
    ds.add_argument("--frames", type=int, default=16)
    ds.add_argument("--size", type=int, default=256)
    ds.add_argument("--channels", type=int, default=1, choices=(1, 3))
    ds.add_argument("--sprites", type=int, default=4)
    ds.add_argument("--seed", type=int, default=0)
    ds.add_argument("--max-speed", type=float, default=6.0,
                    help="sprite speed bound in px/frame (fast tiers "
                         ">= ~16 exceed the shifts-warp --max-flow bound "
                         "at training time)")
    ds.add_argument("--motion", default="linear", choices=("linear", "hard"),
                    help="'linear' = constant velocities (the standard "
                         "harness tier); 'hard' adds camera rotation/zoom, "
                         "sprite acceleration and orbits — curved "
                         "trajectories + occlusions")
    ds.add_argument("--flicker", type=float, default=0.0,
                    help="per-frame exposure flicker amplitude (0 = off; "
                         "0.1-0.2 = fluorescent/auto-exposure flicker with "
                         "a 2.5-5 frame period — the illumination-"
                         "robustness tier that motivates --census)")

    c = sub.add_parser("convert", help="convert checkpoints between the "
                                       "reference .pth format and the "
                                       "port's export directory")
    c.add_argument("--input", required=True, help=".pth file or export dir")
    c.add_argument("--output", required=True, help="export dir or .pth file")
    c.add_argument("--channels", type=int, default=1, choices=(1, 3))
    c.add_argument("--bilinear", action="store_true", default=None)

    return p


def _model_config(args) -> Optional[ModelConfig]:
    """The config the model flags give, or None where they give none (the
    checkpoint's then applies), as JAX's ``_load_engine`` builds it."""
    if not (args.channels or getattr(args, "s2d", None)
            or getattr(args, "refine_width", None)
            or getattr(args, "arch", None)):
        return None
    return ModelConfig(arch=getattr(args, "arch", None) or "unet",
                       channels=args.channels or 1,
                       space_to_depth=getattr(args, "s2d", None) or 1,
                       refine_width=getattr(args, "refine_width", None) or 0,
                       refine_factor=getattr(args, "refine_factor", None)
                       or 1,
                       upsample=getattr(args, "upsample", None)
                       or "align_corners",
                       refine_depthwise=getattr(args, "refine_depthwise",
                                                False),
                       base_width=getattr(args, "base_width", None) or 64,
                       flow_scale=getattr(args, "flow_scale", None) or 1,
                       warp_impl=getattr(args, "warp_impl", None)
                       or "shifts",
                       max_flow=getattr(args, "max_flow", None) or 32)


def _load_engine(args, allow_random: bool = False):
    import torch

    from .infer.engine import InterpolationEngine

    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    cfg = _model_config(args)
    kw = dict(compute_dtype=dtype, device=getattr(args, "device", None),
              core_impl=getattr(args, "core_impl", None) or "xla",
              core_pack=getattr(args, "core_pack", 1) or 1)
    if os.path.exists(args.model) or args.model.endswith((".pth", ".pt")):
        return InterpolationEngine.from_checkpoint(args.model, cfg, **kw)
    if allow_random:
        print(f"warning: no checkpoint at '{args.model}', using random "
              "weights (plumbing/demo mode)")
        return InterpolationEngine.random_init(cfg or ModelConfig(), **kw)
    raise SystemExit(f"error: checkpoint not found: {args.model}")


# ---------------------------------------------------------------------------
# subcommands
# ---------------------------------------------------------------------------

def _train_devices(args):
    """(device, count) for ``train``: ``--num-devices -1`` counts every
    visible card, or 1 on ``--device cpu``; on the CPU any count runs
    that many processes. More cards than are visible raise JAX's
    ``make_mesh`` error."""
    import torch

    from .infer.engine import resolve_device

    device = resolve_device(args.device)
    n_dev = args.num_devices
    cards = torch.cuda.device_count() if device.type == "cuda" else None
    if n_dev in (-1, None):
        n_dev = cards if cards is not None else 1
    if n_dev < 1:
        raise ValueError(f"--num-devices must be -1 or >= 1, got {n_dev}")
    if cards is not None and n_dev > cards:
        raise ValueError(f"requested {n_dev} devices, only {cards} visible")
    return device, n_dev


def _on_cpu(args) -> bool:
    return args.device is not None and args.device.startswith("cpu")


def _train_plan(args, n_dev: int, verbose: bool = True):
    """(train triplets, val triplets, global batch): JAX's batch rounded
    up to a multiple of ``n_dev`` and clamped against the train set, with
    JAX's notes."""
    from .data.triplets import scan_triplets, split_triplets
    from .parallel.mesh import pad_batch_to_devices

    say = print if verbose else (lambda *a: None)
    batch = pad_batch_to_devices(args.batch_size, n_dev)
    if batch != args.batch_size:
        say(f"note: batch size rounded up to {batch} "
            f"(divisible by {n_dev} devices)")
    triplets = scan_triplets(args.data_dir)
    if len(triplets) < 2:
        raise SystemExit(f"error: not enough triplets in {args.data_dir} "
                         f"(found {len(triplets)}; need frame_*.png videos "
                         "with >= 3 frames)")
    train_t, val_t = split_triplets(triplets, args.val_split, args.seed)
    if batch > len(train_t):
        # the train loader drops the remainder, so a batch larger than the
        # train set would yield ZERO steps per epoch
        clamped = (len(train_t) // n_dev) * n_dev
        if clamped == 0:
            raise SystemExit(
                f"error: only {len(train_t)} train triplets for {n_dev} "
                "devices; add data or reduce --num-devices/--val-split")
        say(f"note: batch size clamped to {clamped} "
            f"(only {len(train_t)} train triplets; drop-remainder "
            "batching would otherwise yield zero steps/epoch)")
        batch = clamped
    say(f"dataset: {len(triplets)} triplets "
        f"({len(train_t)} train / {len(val_t)} val), "
        f"{n_dev}-device mesh, global batch {batch}")
    return train_t, val_t, batch


def _train_ranked(args, verbose: bool = True) -> int:
    """Train as this process's rank of the group that torchrun's
    environment describes (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``): NCCL on its card, gloo on
    the CPU with ``--device cpu``. Rank 0 prints, and the plan too where
    ``verbose``; the group is left at the end."""
    import torch.distributed as dist

    from .parallel.mesh import make_mesh, maybe_init_distributed

    cpu = _on_cpu(args)
    maybe_init_distributed("gloo" if cpu else "nccl")
    try:
        world = dist.get_world_size()
        mesh = make_mesh(args.num_devices,
                         devices=["cpu"] * world if cpu else None)
        plan = _train_plan(args, mesh.size, verbose and mesh.rank == 0)
        return _train(args, *plan, mesh=mesh)
    finally:
        dist.destroy_process_group()


def _train_worker(rank: int, args, n_dev: int, port: int,
                  threads: int) -> None:
    """Rank ``rank`` of ``cmd_train``'s ``n_dev`` processes: torchrun's
    environment for a group at 127.0.0.1:``port``, then
    :func:`_train_ranked`; on the CPU with its share of the launcher's
    ``threads`` (oversubscribed cores slow every rank down tenfold)."""
    import torch

    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE=str(n_dev), RANK=str(rank),
                      LOCAL_RANK=str(rank))
    if _on_cpu(args):
        torch.set_num_threads(max(1, threads // n_dev))
    _train_ranked(args, verbose=False)


def _spawn_workers(worker, n: int, args: tuple) -> int:
    """``worker(rank, *args)`` in ``n`` processes: 0 when every one ends
    well; else 1, with the first failing worker's error, the others
    ended."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    try:
        mp.spawn(worker, args=args, nprocs=n, join=True)
    except ProcessException as e:
        print(f"error: a training worker failed: {e}", file=sys.stderr)
        return 1
    return 0


def cmd_train(args) -> int:
    """Train on ``--num-devices`` cards: one in this process; more, one
    process each (``torch.multiprocessing.spawn``) meeting at 127.0.0.1 on
    a free port; under torchrun's environment this process joins the
    group it was given instead (:func:`_train_ranked`). A worker that
    fails ends the others and the command, with its error."""
    import torch

    from .parallel.mesh import free_port, launched

    if launched():
        return _train_ranked(args)
    device, n_dev = _train_devices(args)
    plan = _train_plan(args, n_dev)
    if n_dev == 1:
        return _train(args, *plan, device=device)
    return _spawn_workers(_train_worker, n_dev, (
        args, n_dev, free_port(), torch.get_num_threads()))


def _train(args, train_t, val_t, batch: int, device=None, mesh=None) -> int:
    """Train on the plan's triplets at global batch ``batch``, on
    ``device``, or data parallel on ``mesh`` (a process group's); rank 0
    prints."""
    from .config import LossConfig
    from .data.loader import TripletLoader
    from .infer.engine import _init_weights
    from .models import build_model
    from .models.unet import count_parameters
    from .train.checkpoint import Checkpointer, save_variables
    from .train.loop import History, create_train_state, train_model

    import torch

    if mesh is not None:
        device = mesh.device
    say = print if mesh is None or mesh.rank == 0 else (lambda *a: None)
    mcfg = ModelConfig(arch=args.arch, channels=args.channels,
                       space_to_depth=args.s2d, residual=args.residual,
                       refine_width=args.refine_width,
                       refine_factor=args.refine_factor,
                       upsample=args.upsample,
                       refine_depthwise=args.refine_depthwise,
                       base_width=args.base_width,
                       flow_scale=args.flow_scale,
                       flow_bidir=args.flow_bidir,
                       flow_cascade=args.flow_cascade,
                       warp_impl=args.warp_impl,
                       max_flow=args.max_flow)
    if args.flow_bidir and args.arch != "flow":
        raise SystemExit("error: --flow-bidir requires --arch flow")
    if args.flow_cascade and args.arch != "flow":
        raise SystemExit("error: --flow-cascade requires --arch flow")
    if args.flow_smooth > 0 and args.arch != "flow":
        raise SystemExit("error: --flow-smooth regularizes the flow "
                         "family's motion field; it requires --arch flow")
    if args.flow_photo > 0 and args.arch != "flow":
        raise SystemExit("error: --flow-photo supervises the flow "
                         "family's motion field; it requires --arch flow")
    if args.grad_accum < 1 or batch % args.grad_accum:
        raise SystemExit(f"error: --grad-accum must divide the batch size "
                         f"evenly (batch {batch}, accum {args.grad_accum})")
    tcfg = TrainConfig(epochs=args.epochs, batch_size=batch,
                       learning_rate=args.lr, val_split=args.val_split,
                       seed=args.seed, checkpoint_dir=args.checkpoint_dir,
                       ema_decay=args.ema_decay, augment=args.augment,
                       save_every=args.save_every,
                       grad_accum=args.grad_accum,
                       loss=LossConfig(flow_smooth_weight=args.flow_smooth,
                                       flow_photo_weight=args.flow_photo,
                                       census_weight=args.census,
                                       census_window=args.census_window))

    kw = dict(batch_size=batch, height=args.height, width=args.width,
              grayscale=args.channels == 1, num_workers=args.num_workers,
              device=device, mesh=mesh)
    train_loader = TripletLoader(train_t, seed=args.seed + 1,
                                 augment=args.augment,
                                 grad_accum=args.grad_accum, **kw)
    val_loader = TripletLoader(val_t, shuffle=False, drop_remainder=False, **kw)

    def fresh_model():
        model = build_model(mcfg)
        _init_weights(model, torch.Generator().manual_seed(args.seed))
        return model

    model = fresh_model()
    say(f"model: {count_parameters(model):,} parameters")

    ckpt = Checkpointer(args.checkpoint_dir, device=device)
    start_epoch, state, history = 0, None, None
    if args.resume and ckpt.has_checkpoint("latest"):
        state0 = create_train_state(model, None, tcfg, device)
        state, start_epoch, hist_dict = ckpt.restore(state0, which="latest")
        if hist_dict:
            history = History(**hist_dict)
        say(f"resumed from epoch {start_epoch}")

    state, history = train_model(model, None, train_loader, val_loader,
                                 tcfg, device=device, checkpointer=ckpt,
                                 start_epoch=start_epoch, state=state,
                                 history=history, mesh=mesh)
    # export the best weights for inference, with the model config (the EMA
    # weights when EMA is on: they are what validation ranked)
    best, _, _ = ckpt.restore(create_train_state(fresh_model(), None, tcfg,
                                                 device), which="best")
    save_variables(args.checkpoint_dir,
                   best.variables(use_ema=tcfg.ema_decay > 0
                                  and best.ema_params is not None), mcfg)
    say(f"checkpoints in {args.checkpoint_dir}/ "
        "(best exported for inference)")
    return 0


def cmd_infer(args) -> int:
    from .data.video import VideoWriter
    from .infer.engine import InterpolationEngine
    from .ops.image import load_image, save_image

    engine = _load_engine(args, allow_random=True)
    gray = engine.cfg.channels == 1
    size = (args.height, args.width)
    f1 = load_image(args.frame1, grayscale=gray, size=size)
    f2 = load_image(args.frame2, grayscale=gray, size=size)
    n = args.num_intermediate
    if n < 1:
        raise SystemExit("error: --num-intermediate must be >= 1")

    if n == 1:
        mid = engine.interpolate_pair(f1, f2)
        save_image(args.output, mid)
        print(f"wrote {args.output}")
        return 0

    mids = engine.generate_intermediate_frames(f1, f2, n)
    base, _ = os.path.splitext(args.output)
    for i, m in enumerate(mids, 1):
        save_image(f"{base}_intermediate_{i:02d}.png", m)
    video_path = f"{base}_video.mp4"
    with VideoWriter(video_path, fps=args.fps) as w:
        for fr in [f1, *mids, f2]:
            w.write(fr)
    print(f"wrote {n} intermediate frames + {video_path}")
    if args.save_comparison:
        cmp_path = f"{base}_comparison.mp4"
        blends = InterpolationEngine.linear_transition_frames(f1, f2, n)
        with VideoWriter(cmp_path, fps=args.fps) as w:
            for fr in [f1, *blends, f2]:
                w.write(fr)
        print(f"wrote {cmp_path} (linear-blend comparison)")
    return 0


def cmd_video(args) -> int:
    engine = _load_engine(args, allow_random=True)
    if args.target_fps is not None:
        stats = engine.retime_video_file(args.input, args.output,
                                         target_fps=args.target_fps,
                                         batch_pairs=args.batch_pairs)
        print(f"{args.input} -> {args.output}: "
              f"{stats['input_frames']} frames @ {stats['input_fps']:.2f} fps "
              f"-> {stats['output_frames']} frames @ "
              f"{stats['output_fps']:.2f} fps (rate {stats['rate']:.3f}, "
              f"{stats['frames_per_second']:.1f} out-frames/s)")
        return 0
    stats = engine.interpolate_video_file(
        args.input, args.output, factor=args.factor,
        batch_pairs=args.batch_pairs, fps=args.fps)
    print(f"{args.input} -> {args.output}: "
          f"{stats['input_frames']} -> {stats['output_frames']} frames "
          f"@ {stats['output_fps']:.1f} fps "
          f"({stats['frames_per_second']:.1f} out-frames/s)")
    return 0


def cmd_eval(args) -> int:
    from .eval.harness import evaluate_model
    from .eval.report import generate_full_report, print_summary

    engine = _load_engine(args, allow_random=True)
    results = evaluate_model(
        engine, test_dir=args.test_dir, batch_size=args.batch_size,
        height=args.height, width=args.width,
        save_frames_dir=os.path.join(args.output_dir, "frames")
        if args.save_frames else None,
        max_triplets=args.max_triplets, progress=True)
    print_summary(results)
    artifacts = generate_full_report(results, args.output_dir, engine=engine,
                                     height=args.height, width=args.width)
    print(f"report artifacts in {args.output_dir}/ "
          f"(json, csv, plots, report.md, comparisons)")
    return 0


def cmd_serve(args) -> int:
    from .serve.server import Server, warmup

    engine = _load_engine(args, allow_random=True)
    cfg = ServeConfig(host=args.host, port=args.port, model_path=args.model)
    if not args.no_warmup:
        print("warmup: running the serving path once (builds the "
              "kernels on the card)...", flush=True)
        dt = warmup(engine, (args.height, args.width))
        print(f"warmup done in {dt:.1f}s", flush=True)
    try:
        server = Server(engine, cfg, resolution=(args.height, args.width))
    except OSError as e:
        raise SystemExit(f"error: cannot bind {args.host}:{args.port} ({e})")
    print(f"serving on http://{args.host}:{server.port}  "
          "(POST /interpolate, GET /, /health, /model-info)", flush=True)
    # process managers stop services with SIGTERM; exit through the same
    # clean path as Ctrl-C (closes the socket)
    import signal

    def _term(signum, frame):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("\nshutting down")
        server.shutdown()
    return 0


def cmd_info(args) -> int:
    import dataclasses
    import json

    if args.model.endswith((".pth", ".pt")):
        import torch

        ckpt = torch.load(args.model, map_location="cpu", weights_only=False)
        print(f"PyTorch checkpoint: {args.model}")
        if isinstance(ckpt, dict) and "model_state_dict" in ckpt:
            # reference format; tolerate missing keys
            for key in ("epoch", "train_loss", "val_loss"):
                val = ckpt.get(key)
                if isinstance(val, float):
                    print(f"  {key}: {val:.6f}")
                elif val is not None:
                    print(f"  {key}: {val}")
            sd = ckpt["model_state_dict"]
        else:
            sd = ckpt
        n = sum(int(v.numel()) for v in sd.values()
                if hasattr(v, "numel") and v.dtype.is_floating_point)
        print(f"  parameters: {n:,}")
        return 0

    from .models import build_model
    from .models.unet import count_parameters, fold_batchnorm
    from .train.checkpoint import load_variables

    if not os.path.exists(args.model):
        raise SystemExit(f"error: checkpoint not found: {args.model}")
    if not os.path.exists(os.path.join(args.model, "variables.pt")):
        raise FileNotFoundError(
            f"no checkpoint at {args.model} (expected a .pth file or a "
            "directory with variables.pt, written by save_variables)")
    # the inference model on the host: folded, as an engine holds it
    variables, loaded = load_variables(args.model)
    cfg = _model_config(args) or loaded or ModelConfig()
    model = build_model(cfg, folded=True)
    model.load_state_dict(fold_batchnorm(variables))
    print(f"checkpoint: {args.model}")
    print(f"  model config: {dataclasses.asdict(cfg)}")
    print(f"  parameters: {count_parameters(model):,}")
    meta_path = os.path.join(args.model, "latest_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
        # meta['epoch'] is the 0-indexed last finished epoch (what resume
        # restores from); report the human count
        done = meta.get("epoch")
        print(f"  epochs completed: {done + 1 if isinstance(done, int) else '?'}")
        hist = meta.get("history") or {}
        if hist.get("val_loss"):
            print(f"  best val loss: {min(hist['val_loss']):.6f}")
            print(f"  last val psnr: {hist['val_psnr'][-1]:.2f} dB, "
                  f"ssim {hist['val_ssim'][-1]:.4f}")
    return 0


def cmd_demo(args) -> int:
    """Fixture generation + component smoke run (capability of reference
    ``demo_simple.py`` / ``test_basic.py``, through the real APIs)."""
    import numpy as np

    from .data.synthetic import write_fixture_tree, write_fixture_video
    from .eval.harness import evaluate_model
    from .eval.report import print_summary
    from .infer.engine import InterpolationEngine

    print("1) writing moving-circle fixtures")
    dirs = write_fixture_tree(args.output_dir, num_videos=1, num_frames=5,
                              height=args.size, width=args.size)
    clip = write_fixture_video(
        os.path.join(args.output_dir, "sample_clip.mp4"),
        num_frames=8, height=args.size, width=args.size)
    print(f"   {dirs[0]}/  and  {clip}")

    print("2) building the model (random weights) + forward pass")
    engine = InterpolationEngine.random_init(ModelConfig(),
                                             device=args.device)
    f = np.zeros((args.size, args.size, 1), np.uint8)
    mid = engine.interpolate_pair(f, f)
    print(f"   forward ok: {mid.shape} {mid.dtype}")

    print("3) 3-method evaluation on the fixture")
    results = evaluate_model(engine, test_dir=args.output_dir,
                             height=args.size, width=args.size)
    print_summary(results)

    print("4) 2x video interpolation on the fixture clip")
    out_clip = os.path.join(args.output_dir, "sample_clip_2x.mp4")
    stats = engine.interpolate_video_file(clip, out_clip, factor=2,
                                          batch_pairs=4)
    print(f"   {stats['input_frames']} -> {stats['output_frames']} frames "
          f"({out_clip})")
    print("demo complete — train on real data with: fi-torch train "
          f"--data-dir {args.output_dir}")
    return 0


def cmd_dataset(args) -> int:
    """Generate a procedural training dataset: textured panning backgrounds
    with multiple anti-aliased moving sprites (``data/synthetic.py``)."""
    from .data.synthetic import write_scene_tree

    dirs = write_scene_tree(args.output_dir, num_videos=args.videos,
                            num_frames=args.frames, height=args.size,
                            width=args.size, channels=args.channels,
                            num_sprites=args.sprites, seed=args.seed,
                            motion=args.motion,
                            max_speed=args.max_speed,
                            flicker=args.flicker)
    n_triplets = args.videos * max(0, args.frames - 2)
    print(f"wrote {len(dirs)} clips x {args.frames} frames "
          f"({n_triplets} triplets) to {args.output_dir}")
    print(f"train with: fi-torch train --data-dir {args.output_dir}")
    return 0


def cmd_convert(args) -> int:
    """A reference ``.pth`` -> the port's export directory
    (``save_variables``), or an export directory -> a ``.pth``. The config
    of a ``.pth`` comes from its weights (``pth_config``). Orbax
    directories need JAX: ``scripts/torch_convert_orbax.py`` converts them
    to and from export directories."""
    from .train.checkpoint import (export_pth, import_pth, load_variables,
                                   pth_config, save_variables)

    if args.input.endswith((".pth", ".pt")):
        variables = import_pth(args.input)
        save_variables(args.output, variables, pth_config(variables))
        print(f"{args.input} (PyTorch) -> {args.output} (export directory)")
        return 0
    if not os.path.exists(os.path.join(args.input, "variables.pt")):
        raise FileNotFoundError(
            f"{args.input}: no variables.pt (an export directory written by "
            "save_variables); convert an Orbax directory into one with "
            "scripts/torch_convert_orbax.py, which needs the JAX package")
    if not args.output.endswith((".pth", ".pt")):
        raise SystemExit("error: output must be a .pth file when "
                         "converting from an export directory")
    variables, cfg = load_variables(args.input)
    export_pth(args.output, variables, cfg)
    print(f"{args.input} (export directory) -> {args.output} (PyTorch "
          "reference format)")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return {"train": cmd_train, "infer": cmd_infer, "video": cmd_video,
                "eval": cmd_eval, "serve": cmd_serve, "demo": cmd_demo,
                "convert": cmd_convert, "dataset": cmd_dataset,
                "info": cmd_info}[args.command](args)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    raise SystemExit(main())
