"""Evaluation reports, text artifacts (JAX ``eval/report.py``): the
console summary, JSON results, the CSV summary and the markdown report
with rankings, the reference's quality bands (PSNR >30 excellent / 25-30
good / 20-25 acceptable / <20 poor, SSIM >0.95 / 0.90 / 0.80,
``evaluation.py:709-719,827-843``) and recommendations.

The CSV is written with the ``csv`` module in the columns and row order
that pandas writes; the card's machine has no pandas and no matplotlib, so
the plots, the frame comparisons and ``generate_full_report`` wait for the
CLI slice (ROADMAP Queue A, serving and the CLI).
"""

from __future__ import annotations

import csv
import json
import math
import os
from typing import Optional

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
