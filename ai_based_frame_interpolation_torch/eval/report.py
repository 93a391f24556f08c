"""Evaluation reports, text artifacts (JAX ``eval/report.py``): the
console summary, JSON results, the CSV summary and the markdown report
with rankings, the reference's quality bands (PSNR >30 excellent / 25-30
good / 20-25 acceptable / <20 poor, SSIM >0.95 / 0.90 / 0.80,
``evaluation.py:709-719,827-843``) and recommendations.

The CSV is written with the ``csv`` module in the columns and row order
that pandas writes. The plots and the frame comparisons draw with
matplotlib, imported inside the functions that draw: the card's machine
has no matplotlib (and no pandas), so there :func:`save_plots`, and with it
:func:`generate_full_report`, raise an ``ImportError``. The comparisons
run the port's engine; their Farneback panel needs OpenCV.
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import List, Optional, Sequence

import numpy as np

# fixed categorical assignment: method -> hue (never cycled / reordered)
METHOD_COLORS = {"unet": "#2a78d6", "linear": "#eb6834",
                 "optical_flow": "#1baf7a"}
_FALLBACK_COLORS = ["#eda100", "#e87ba4", "#008300", "#4a3aa7"]
SURFACE = "#fcfcfb"
TEXT_PRIMARY = "#0b0b0b"
TEXT_SECONDARY = "#52514e"
GRID = "#e4e3df"

METHOD_LABELS = {"unet": "U-Net", "linear": "Linear blend",
                 "optical_flow": "Optical flow (Farneback)"}

PSNR_BANDS = [(30.0, "excellent"), (25.0, "good"), (20.0, "acceptable"),
              (-1e9, "poor")]
SSIM_BANDS = [(0.95, "excellent"), (0.90, "good"), (0.80, "acceptable"),
              (-1e9, "poor")]


def _band(value: float, bands) -> str:
    for thresh, name in bands:
        if value > thresh:
            return name
    return "poor"


def _color(method: str, i: int) -> str:
    return METHOD_COLORS.get(method, _FALLBACK_COLORS[i % len(_FALLBACK_COLORS)])


def _label(method: str) -> str:
    return METHOD_LABELS.get(method, method)


def print_summary(results: dict, log_fn=print) -> None:
    mm = results["metrics_by_method"]
    log_fn("=" * 64)
    log_fn("EVALUATION SUMMARY "
           f"({results.get('num_triplets', '?')} triplets)")
    log_fn("=" * 64)
    for m in results["methods"]:
        p, s = mm[m]["psnr"], mm[m]["ssim"]
        log_fn(f"{_label(m):28s} PSNR {p['avg']:6.2f} ± {p['std']:5.2f} dB   "
               f"SSIM {s['avg']:.4f} ± {s['std']:.4f}")
    if "linear" in mm:
        base_p = mm["linear"]["psnr"]["avg"]
        base_s = mm["linear"]["ssim"]["avg"]
        log_fn("-" * 64)
        for m in results["methods"]:
            if m == "linear":
                continue
            dp = mm[m]["psnr"]["avg"] - base_p
            ds = mm[m]["ssim"]["avg"] - base_s
            log_fn(f"{_label(m):28s} vs linear: "
                   f"PSNR {dp:+.2f} dB, SSIM {ds:+.4f}")
    log_fn("=" * 64)


def save_json(results: dict, path: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(results, f, indent=2)
    return path


def save_csv_summary(results: dict, path: str) -> str:
    """One row per method: ``method``, then ``psnr_{avg,std,min,max}`` and
    ``ssim_{avg,std,min,max}``; the text ``DataFrame.to_csv(index=False)``
    writes (shortest round-trip floats, NaN as an empty field)."""
    rows = []
    for m in results["methods"]:
        mm = results["metrics_by_method"][m]
        rows.append({"method": m,
                     **{f"psnr_{k}": v for k, v in mm["psnr"].items()},
                     **{f"ssim_{k}": v for k, v in mm["ssim"].items()}})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        if not rows:
            f.write("\n")
            return path
        writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows({k: "" if isinstance(v, float) and math.isnan(v)
                          else v for k, v in r.items()} for r in rows)
    return path


def _styled_axis(ax, ylabel: str):
    ax.set_facecolor(SURFACE)
    ax.grid(axis="y", color=GRID, linewidth=0.8, zorder=0)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(GRID)
    ax.tick_params(colors=TEXT_SECONDARY, labelsize=9)
    ax.set_ylabel(ylabel, color=TEXT_SECONDARY, fontsize=10)


def _bar_metric(ax, results: dict, metric: str, ylabel: str,
                errorbars: bool = False):
    methods = results["methods"]
    mm = results["metrics_by_method"]
    xs = np.arange(len(methods))
    vals = [mm[m][metric]["avg"] for m in methods]
    errs = [mm[m][metric]["std"] for m in methods] if errorbars else None
    colors = [_color(m, i) for i, m in enumerate(methods)]
    ax.bar(xs, vals, width=0.55, color=colors, zorder=2,
           yerr=errs, capsize=4 if errorbars else 0,
           error_kw={"ecolor": TEXT_SECONDARY, "elinewidth": 1.2},
           edgecolor=SURFACE, linewidth=2)
    for x, v in zip(xs, vals):
        ax.annotate(f"{v:.2f}" if metric == "psnr" else f"{v:.3f}",
                    (x, v), textcoords="offset points", xytext=(0, 4),
                    ha="center", fontsize=9, color=TEXT_PRIMARY)
    ax.set_xticks(xs)
    ax.set_xticklabels([_label(m) for m in methods], color=TEXT_PRIMARY,
                       fontsize=9)
    _styled_axis(ax, ylabel)


def save_plots(results: dict, out_dir: str) -> List[str]:
    """The reference's four chart sets (``evaluation.py:558-643``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    written = []

    def fig_one(metric, ylabel, fname, errorbars=False):
        fig, ax = plt.subplots(figsize=(6, 4), facecolor=SURFACE)
        _bar_metric(ax, results, metric, ylabel, errorbars)
        ax.set_title(f"Mean {ylabel} by method", color=TEXT_PRIMARY,
                     fontsize=11, loc="left")
        fig.tight_layout()
        path = os.path.join(out_dir, fname)
        fig.savefig(path, dpi=150, facecolor=SURFACE)
        plt.close(fig)
        written.append(path)

    fig_one("psnr", "PSNR (dB)", "psnr_comparison.png")
    fig_one("ssim", "SSIM", "ssim_comparison.png")
    fig_one("psnr", "PSNR (dB)", "psnr_with_std.png", errorbars=True)

    # combined: two panels, one metric per axis (never dual-axis)
    fig, axes = plt.subplots(1, 2, figsize=(11, 4), facecolor=SURFACE)
    _bar_metric(axes[0], results, "psnr", "PSNR (dB)")
    _bar_metric(axes[1], results, "ssim", "SSIM")
    fig.suptitle("Interpolation quality by method", color=TEXT_PRIMARY,
                 fontsize=12, x=0.02, ha="left")
    fig.tight_layout(rect=(0, 0, 1, 0.94))
    path = os.path.join(out_dir, "combined_comparison.png")
    fig.savefig(path, dpi=150, facecolor=SURFACE)
    plt.close(fig)
    written.append(path)

    write_plots_readme(results, out_dir)
    written.append(os.path.join(out_dir, "README.md"))
    return written


def write_plots_readme(results: dict, out_dir: str) -> str:
    """Plots index (reference ``evaluation.py:655-734``)."""
    mm = results["metrics_by_method"]
    lines = ["# Evaluation plots", "",
             "| File | Contents |", "|---|---|",
             "| psnr_comparison.png | mean PSNR per method |",
             "| ssim_comparison.png | mean SSIM per method |",
             "| psnr_with_std.png | mean PSNR with std error bars |",
             "| combined_comparison.png | PSNR + SSIM side by side |", "",
             "## Numbers", "",
             "| Method | PSNR (dB) | SSIM |", "|---|---|---|"]
    for m in results["methods"]:
        lines.append(f"| {_label(m)} | {mm[m]['psnr']['avg']:.2f} | "
                     f"{mm[m]['ssim']['avg']:.4f} |")
    path = os.path.join(out_dir, "README.md")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def write_markdown_report(results: dict, path: str,
                          extra_notes: Optional[str] = None) -> str:
    """Rankings, quality bands, recommendations (``evaluation.py:736-899``)."""
    mm = results["metrics_by_method"]
    methods = results["methods"]
    by_psnr = sorted(methods, key=lambda m: -mm[m]["psnr"]["avg"])
    by_ssim = sorted(methods, key=lambda m: -mm[m]["ssim"]["avg"])

    lines = ["# Frame-interpolation evaluation report", "",
             f"Triplets evaluated: **{results.get('num_triplets', '?')}**", "",
             "## Results", "",
             "| Method | PSNR avg | PSNR std | PSNR min/max | SSIM avg | "
             "SSIM std | SSIM min/max | Quality (PSNR) | Quality (SSIM) |",
             "|---|---|---|---|---|---|---|---|---|"]
    for m in methods:
        p, s = mm[m]["psnr"], mm[m]["ssim"]
        lines.append(
            f"| {_label(m)} | {p['avg']:.2f} | {p['std']:.2f} | "
            f"{p['min']:.2f}/{p['max']:.2f} | {s['avg']:.4f} | "
            f"{s['std']:.4f} | {s['min']:.4f}/{s['max']:.4f} | "
            f"{_band(p['avg'], PSNR_BANDS)} | {_band(s['avg'], SSIM_BANDS)} |")

    lines += ["", "## Rankings", "",
              "By PSNR: " + " > ".join(_label(m) for m in by_psnr), "",
              "By SSIM: " + " > ".join(_label(m) for m in by_ssim), ""]

    lines += ["## Quality bands", "",
              "- PSNR: >30 dB excellent, 25-30 good, 20-25 acceptable, <20 poor",
              "- SSIM: >0.95 excellent, 0.90-0.95 good, 0.80-0.90 acceptable, "
              "<0.80 poor", ""]

    lines += ["## Recommendations", ""]
    best = by_ssim[0]
    if best == "unet":
        lines.append("- The learned U-Net leads on SSIM; prefer it for "
                     "production interpolation.")
    else:
        lines.append(f"- {_label(best)} currently leads on SSIM; the U-Net "
                     "likely needs more training data or epochs.")
    if "linear" in mm and "unet" in mm:
        d = mm["unet"]["ssim"]["avg"] - mm["linear"]["ssim"]["avg"]
        lines.append(f"- U-Net SSIM improvement over linear blending: {d:+.4f}.")
    worst_band = _band(mm[by_psnr[0]]["psnr"]["avg"], PSNR_BANDS)
    if worst_band in ("acceptable", "poor"):
        lines.append("- Best method is only rated "
                     f"'{worst_band}'; consider higher-resolution training "
                     "or longer schedules.")
    if extra_notes:
        lines += ["", "## Notes", "", extra_notes]

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return path


def save_frame_comparisons(results: dict, engine, out_dir: str,
                           height: int = 256, width: int = 256,
                           which: Sequence[str] = ("best", "median", "worst")
                           ) -> List[str]:
    """Side-by-side (inputs | per-method predictions | GT) for triplets picked
    by U-Net PSNR (reference ``evaluation.py:901-1066``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..data.triplets import Triplet, load_triplet_arrays
    from ..ops.flow import farneback_midpoint, linear_midpoint

    ranked = sorted(results["results_by_method"]["unet"],
                    key=lambda r: r["psnr"])
    if not ranked:
        return []
    picks = {"worst": ranked[0], "median": ranked[len(ranked) // 2],
             "best": ranked[-1]}
    os.makedirs(out_dir, exist_ok=True)
    grayscale = engine.cfg.channels == 1
    written = []
    for name in which:
        r = picks[name]
        # result records carry the actual filenames (harness.py), so any
        # frame naming scheme works here
        t = Triplet(video_dir=r["video_dir"], video_name=r["video_name"],
                    triplet_id=r["triplet_id"],
                    frame_t0=r.get("frame_t0",
                                   f"frame_{r['triplet_id']:03d}.png"),
                    frame_t1=r.get("frame_t1",
                                   f"frame_{r['triplet_id'] + 2:03d}.png"),
                    ground_truth=r.get("ground_truth",
                                       f"frame_{r['triplet_id'] + 1:03d}.png"))
        try:
            f0, f1, gt = load_triplet_arrays(t, height, width, grayscale)
        except Exception:
            continue
        panels = [("frame t", f0), ("frame t+2", f1),
                  ("U-Net", engine.interpolate_pair(f0, f1)),
                  ("linear", linear_midpoint(f0, f1)),
                  ("optical flow", farneback_midpoint(f0, f1)),
                  ("ground truth", gt)]
        fig, axes = plt.subplots(1, len(panels), figsize=(3 * len(panels), 3.4),
                                 facecolor=SURFACE)
        for ax, (title, img) in zip(axes, panels):
            ax.imshow(img[..., 0] if img.shape[-1] == 1 else img,
                      cmap="gray" if img.shape[-1] == 1 else None,
                      vmin=0, vmax=255)
            ax.set_title(title, fontsize=9, color=TEXT_PRIMARY)
            ax.axis("off")
        fig.suptitle(f"{name} by U-Net PSNR ({r['psnr']:.2f} dB) — "
                     f"{r['video_name']} #{r['triplet_id']}",
                     color=TEXT_PRIMARY, fontsize=11)
        fig.tight_layout()
        path = os.path.join(out_dir, f"comparison_{name}.png")
        fig.savefig(path, dpi=130, facecolor=SURFACE)
        plt.close(fig)
        written.append(path)
    return written


def generate_full_report(results: dict, out_dir: str, engine=None,
                         height: int = 256, width: int = 256) -> dict:
    """One call -> the whole artifact suite. Returns paths."""
    os.makedirs(out_dir, exist_ok=True)
    artifacts = {
        "json": save_json(results, os.path.join(out_dir, "results.json")),
        "csv": save_csv_summary(results, os.path.join(out_dir, "summary.csv")),
        "plots": save_plots(results, os.path.join(out_dir, "plots")),
        "report": write_markdown_report(
            results, os.path.join(out_dir, "report.md")),
    }
    if engine is not None and "unet" in results["results_by_method"]:
        artifacts["comparisons"] = save_frame_comparisons(
            results, engine, os.path.join(out_dir, "comparisons"),
            height, width)
    return artifacts
