"""Evaluation harness: U-Net vs the linear and optical-flow baselines (JAX
``eval/harness.py``).

Reads frame triplets from disk, runs each method over them in chunks of
``batch_size``, computes PSNR and skimage SSIM batched on the device (the
``ssim_eval`` CUDA kernel for CUDA tensors), and returns the reference's
coherent schema ``{methods, num_triplets, results_by_method,
metrics_by_method}`` (``model/evaluation_simple.py:134-244``). A triplet
that fails to load is skipped, as in the reference.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..data.triplets import Triplet, load_triplet_arrays, scan_triplets
from ..infer.engine import InterpolationEngine, resolve_device
from ..ops.flow import farneback_midpoint, linear_midpoint
from ..ops.psnr import psnr as psnr_op
from ..ops.ssim_fused import ssim_eval_auto

METHODS = ("unet", "linear", "optical_flow")


def _batched_metrics(preds: np.ndarray, gts: np.ndarray,
                     device: torch.device):
    """Per-image PSNR and SSIM of uint8 [B,H,W,C] batches on ``device``."""
    pd = torch.from_numpy(np.ascontiguousarray(preds)).to(device)
    gd = torch.from_numpy(np.ascontiguousarray(gts)).to(device)
    return (psnr_op(pd, gd).cpu().numpy(),
            ssim_eval_auto(pd, gd).cpu().numpy())


def _aggregate(values: List[float]) -> Dict[str, float]:
    arr = np.asarray(values, np.float64)
    return {"avg": float(arr.mean()), "std": float(arr.std()),
            "min": float(arr.min()), "max": float(arr.max())}


def evaluate_model(engine: Optional[InterpolationEngine],
                   test_dir: Optional[str] = None,
                   triplets: Optional[Sequence[Triplet]] = None,
                   methods: Sequence[str] = METHODS,
                   batch_size: int = 8,
                   height: int = 256, width: int = 256,
                   save_frames_dir: Optional[str] = None,
                   max_triplets: Optional[int] = None,
                   progress: bool = False, device=None) -> dict:
    """Run every method over the triplet set; returns the simple-schema dict.

    ``engine`` may be None when 'unet' is not among ``methods``. Metrics
    run on ``engine.device``, or without an engine on ``device`` (default:
    the CUDA card; raises without one unless ``device="cpu"``).
    """
    if triplets is None:
        if test_dir is None:
            raise ValueError("need test_dir or triplets")
        triplets = scan_triplets(test_dir)
    triplets = list(triplets)[:max_triplets]
    if not triplets:
        raise ValueError("no triplets found to evaluate")
    if "unet" in methods and engine is None:
        raise ValueError("'unet' method requires an engine")
    dev = engine.device if engine is not None else resolve_device(device)

    grayscale = engine.cfg.channels == 1 if engine is not None else True
    results_by_method: Dict[str, List[dict]] = {m: [] for m in methods}

    for start in range(0, len(triplets), batch_size):
        chunk = triplets[start:start + batch_size]
        f0s, f1s, gts, metas = [], [], [], []
        for t in chunk:
            try:
                f0, f1, gt = load_triplet_arrays(t, height, width, grayscale)
            except Exception as e:  # per-item isolation (the reference's)
                if progress:
                    print(f"  skipping {t.paths()[0]}: {e}")
                continue
            f0s.append(f0)
            f1s.append(f1)
            gts.append(gt)
            metas.append(t)
        if not metas:
            continue
        f0b, f1b, gtb = np.stack(f0s), np.stack(f1s), np.stack(gts)

        preds: Dict[str, np.ndarray] = {}
        if "unet" in methods:
            preds["unet"] = engine.interpolate_batch(f0b, f1b)
        if "linear" in methods:
            preds["linear"] = linear_midpoint(f0b, f1b)
        if "optical_flow" in methods:
            # cv2 releases the GIL inside Farneback: thread the host baseline
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(min(4, len(f0s))) as pool:
                preds["optical_flow"] = np.stack(
                    list(pool.map(lambda ab: farneback_midpoint(*ab),
                                  zip(f0s, f1s))))

        for m, pred in preds.items():
            ps, ss = _batched_metrics(pred, gtb, dev)
            for i, t in enumerate(metas):
                results_by_method[m].append({
                    "video_name": t.video_name, "triplet_id": t.triplet_id,
                    "video_dir": t.video_dir, "frame_t0": t.frame_t0,
                    "frame_t1": t.frame_t1, "ground_truth": t.ground_truth,
                    "psnr": float(ps[i]), "ssim": float(ss[i])})
            if save_frames_dir:
                mdir = os.path.join(save_frames_dir, m)
                os.makedirs(mdir, exist_ok=True)
                from ..ops.image import save_image

                for i, t in enumerate(metas):
                    save_image(os.path.join(
                        mdir, f"{t.video_name}_{t.triplet_id:04d}.png"),
                        pred[i])
        if progress:
            done = min(start + batch_size, len(triplets))
            print(f"  evaluated {done}/{len(triplets)} triplets")

    metrics_by_method = {
        m: {"psnr": _aggregate([r["psnr"] for r in rs]),
            "ssim": _aggregate([r["ssim"] for r in rs])}
        for m, rs in results_by_method.items() if rs}
    return {"methods": [m for m in methods if results_by_method.get(m)],
            "num_triplets": len(next(iter(results_by_method.values()), [])),
            "results_by_method": results_by_method,
            "metrics_by_method": metrics_by_method}
