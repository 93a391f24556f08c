"""Data-parallel training of the port on the cards of one host, timed.

    python3 scripts/torch_dp_train.py [--num-devices 4] [--per-card 8]
        [--parts step,cli,engine,grad] [--fault local_batchnorm_backward]

Needs ``--num-devices`` CUDA cards (one for ``grad``). Parts (all by
default), the production U-Net (``chip_smoke.PROD``) at 256x256 gray,
bf16 compute, unless named otherwise:

1. ``step``, the train step alone: ``--num-devices`` ranks on NCCL, one
   card each, every rank timing 10 warm steps on ``--per-card`` items
   with CUDA events (the slowest rank's time counts), beside one card
   timing the step at ``--per-card`` items and at the whole global batch;
2. ``cli``, ``cli train`` as a user runs it, on a scene tree it writes
   (16 clips of 16 frames: 224 triplets, 179 train and 45 val), 2 epochs
   at the global batch, once with ``--num-devices 1`` and once with
   ``--num-devices``: each run's wall time, epoch times (rank 0's log
   lines) and history;
3. ``engine``, the production U-Net and flow engines at 1080p gray 2x,
   b8 and b32: ``InterpolationEngine(mesh=make_mesh(n))`` against the
   engine on one card, the same weights; ms a call over warm calls on the
   host's clock with every card synchronised, and the host's time to
   issue them; the outputs within 1 LSB at b8;
4. ``grad``, smoke phase 12's two-rank gradient check on one card
   (``chip_smoke.dp_two_ranks``), as it runs there and with ``--fault``
   injected, which the check must refuse (exits 1 if it does not).

Prints each card's name and power limit (``nvidia-smi``) and, as its last
line, one JSON object with every number.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402

STEPS = 10
PARTS = ("step", "cli", "engine", "grad")


def batch_on(n: int, device) -> dict:
    f0, f1 = smoke.frames(n, smoke.TRAIN_HW, smoke.TRAIN_HW, seed=5)
    gt = ((f0.astype(np.uint16) + f1) // 2).astype(np.uint8)
    return {k: torch.from_numpy(v).to(device)
            for k, v in (("f0", f0), ("f1", f1), ("gt", gt))}


def step_ms(n: int, mesh=None) -> float:
    """ms per warm train step of the production U-Net on ``n`` items of
    this process's card (CUDA events), data parallel on ``mesh``."""
    from ai_based_frame_interpolation_torch.config import TrainConfig
    from ai_based_frame_interpolation_torch.train.loop import (
        create_train_state, train_step)

    tcfg = TrainConfig(batch_size=n, learning_rate=1e-4, ema_decay=0.9)
    state = create_train_state(smoke.train_model_of(smoke.PROD, 0), None,
                               tcfg, torch.cuda.current_device())
    batch = batch_on(n, torch.cuda.current_device())
    return smoke.cuda_ms(lambda: train_step(
        state, batch, tcfg.loss, ema_decay=tcfg.ema_decay, mesh=mesh), STEPS)


def rank_worker(rank: int, world: int, port: int, per_card: int,
                out: str) -> None:
    import torch.distributed as dist

    from ai_based_frame_interpolation_torch.parallel import make_mesh

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(devices=[f"cuda:{r}" for r in range(world)])
        ms = torch.tensor([step_ms(per_card, mesh)], device="cuda")
        each = [torch.zeros_like(ms) for _ in range(world)]
        for r in range(world):             # all_reduce and broadcast only
            t = ms.clone()
            dist.broadcast(t, r)
            each[r] = t
        if rank == 0:
            with open(out, "w") as f:
                json.dump([float(t) for t in each], f)
    finally:
        dist.destroy_process_group()


def cli_run(data: str, ckpt: str, batch: int, n: int) -> dict:
    cmd = [sys.executable, "-m", "ai_based_frame_interpolation_torch",
           "train", "--data-dir", data, "--epochs", "2", "--batch-size",
           str(batch), "--checkpoint-dir", ckpt, "--num-devices", str(n),
           "--s2d", "4", "--residual", "--refine-width", "64",
           "--upsample", "half_pixel", "--ema-decay", "0.9"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=1200)
    wall = time.perf_counter() - t0
    print(proc.stdout, flush=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    epochs = [float(m) for m in re.findall(r"^epoch .*\(([\d.]+)s\)$",
                                            proc.stdout, re.M)]
    with open(os.path.join(ckpt, "latest_meta.json")) as f:
        history = json.load(f)["history"]
    return {"num_devices": n, "wall_s": wall, "epoch_s": epochs,
            "history": history}


def sync_all() -> None:
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def engine_call_ms(engine, b: int, iters: int) -> dict:
    """ms a warm 1080p gray 2x call at batch ``b``, every card
    synchronised (wall), and the host's ms to issue one."""
    fn = engine._pair_fn(1, 1)
    g1, g2 = smoke.frames(b, 1080, 1920, seed=3)
    d1, d2 = engine._put(g1), engine._put(g2)
    fn(engine.model, d1, d2)
    sync_all()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(engine.model, d1, d2)
    issue = time.perf_counter() - t0
    sync_all()
    wall = time.perf_counter() - t0
    ms = wall * 1e3 / iters
    return {"ms_per_call": ms, "issue_ms_per_call": issue * 1e3 / iters,
            "output_fps": 2 * b * 1e3 / ms}


def engine_part(n: int, card: str) -> dict:
    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.parallel import make_mesh

    mesh = make_mesh(n)
    out = {}
    for name, kw, seed in (("unet", smoke.PROD, 52),
                           ("flow", smoke.FLOW_PROD, 53)):
        cfg = ModelConfig(**kw)
        one = InterpolationEngine.random_init(cfg, seed=seed)
        meshed = InterpolationEngine.random_init(cfg, seed=seed, mesh=mesh)
        f1, f2 = smoke.frames(8, 1080, 1920, seed=51)
        diff = int(np.abs(meshed.interpolate_batch(f1, f2).astype(np.int16)
                          - one.interpolate_batch(f1, f2)).max())
        assert diff <= 1, (name, diff)
        rec = {"max_uint8_diff_b8": diff}
        for b, iters in ((8, 20), (32, 10)):
            for label, eng in (("one_card", one), (f"mesh{n}", meshed)):
                rec[f"{label}_b{b}"] = r = engine_call_ms(eng, b, iters)
                print(f"[{card}] {name} engine 1080p gray 2x b{b} "
                      f"{label}: {r['ms_per_call']:.3f} ms a call (host "
                      f"issues it in {r['issue_ms_per_call']:.3f}), "
                      f"{r['output_fps']:.1f} output fps", flush=True)
        out[name] = rec
        del one, meshed
        torch.cuda.empty_cache()
    return out


def grad_part(card: str, fault: str) -> dict:
    clean = smoke.dp_two_ranks(card)
    faulty = smoke.dp_two_ranks(card, fault=fault)
    return {"clean": clean, "fault": faulty,
            "clean_ok": all(clean[k]["ok"] for k in smoke.DP_STEPS),
            "fault_refused": not any(faulty[k]["ok"]
                                     for k in smoke.DP_STEPS)}


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--num-devices", type=int, default=4)
    p.add_argument("--per-card", type=int, default=smoke.TRAIN_BATCH)
    p.add_argument("--parts", default=",".join(PARTS))
    p.add_argument("--fault", default=smoke.DP_FAULTS[0],
                   choices=smoke.DP_FAULTS)
    args = p.parse_args()
    n, per = args.num_devices, args.per_card
    parts = args.parts.split(",")
    assert set(parts) <= set(PARTS), parts
    need = 1 if parts == ["grad"] else n
    assert torch.cuda.device_count() >= need, torch.cuda.device_count()
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, check=True).stdout.strip().splitlines()
    for c in cards:
        print(c, flush=True)
    record = {"cards": cards, "num_devices": n, "per_card": per}
    if "engine" in parts:
        smoke.build({})
        record["engine"] = engine_part(n, cards[0])
    if "grad" in parts:
        record["grad"] = grad_part(cards[0], args.fault)
    if "step" in parts:
        record["step"] = step_part(n, per, cards[0])
    if "cli" in parts:
        record["cli"] = cli_part(n, per, cards[0])
    print(json.dumps(record), flush=True)
    if "grad" in parts and not (record["grad"]["clean_ok"]
                                and record["grad"]["fault_refused"]):
        return 1
    return 0


def step_part(n: int, per: int, card: str) -> dict:
    import torch.multiprocessing as mp

    from ai_based_frame_interpolation_torch.parallel import free_port

    with tempfile.TemporaryDirectory() as root:
        out = os.path.join(root, "ranks.json")
        mp.spawn(rank_worker, args=(n, free_port(), per, out),
                 nprocs=n, join=True)
        with open(out) as f:
            ranks = json.load(f)
    one = step_ms(per)
    whole = step_ms(n * per)
    s = {"rank_ms": ranks, "dp_samples_per_s": n * per * 1e3 / max(ranks),
         "one_card_ms": one, "one_card_samples_per_s": per * 1e3 / one,
         "one_card_global_batch_ms": whole,
         "one_card_global_batch_samples_per_s": n * per * 1e3 / whole}
    print(f"[{card}] train step b{per} a card 256x256 bf16: {n} cards "
          f"{s['dp_samples_per_s']:.1f} samples/s (ranks {ranks} ms); one "
          f"card b{per} {s['one_card_samples_per_s']:.1f}, one card "
          f"b{n * per} {s['one_card_global_batch_samples_per_s']:.1f}",
          flush=True)
    return s


def cli_part(n: int, per: int, card: str) -> dict:
    from ai_based_frame_interpolation_torch.data.synthetic import (
        write_scene_tree)

    with tempfile.TemporaryDirectory() as root:
        data = os.path.join(root, "data")
        write_scene_tree(data, num_videos=16, num_frames=16,
                         height=smoke.TRAIN_HW, width=smoke.TRAIN_HW)
        runs = [cli_run(data, os.path.join(root, f"ckpt{k}"), n * per, k)
                for k in (1, n)]
    h1, hn = runs[0]["history"], runs[1]["history"]
    diff = {k: max(abs(a - b) for a, b in zip(h1[k], hn[k])) for k in h1}
    print(f"[{card}] cli train 2 epochs at global batch {n * per}: "
          f"1 card {runs[0]['wall_s']:.1f} s (epochs {runs[0]['epoch_s']}), "
          f"{n} cards {runs[1]['wall_s']:.1f} s (epochs "
          f"{runs[1]['epoch_s']}); history max differences {diff}",
          flush=True)
    return {"runs": runs, "history_max_abs_diff": diff}


if __name__ == "__main__":
    sys.exit(main())
