"""Shared pieces of the benchmark's CPU tests: the repository's root, and
tiny sizes of each cell (narrow models, small frames, few samples) that
the CPU runs in seconds."""

from __future__ import annotations

import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

TINY = {
    "pairs": {"model": {"base_width": 8, "refine_width": 8},
              "traffic": {"height": 64, "width": 128, "batch": 2,
                          "pool_batches": 2, "sample": 4,
                          "warmup_calls": 1}},
    "stream": {"model": {"base_width": 8, "refine_width": 8},
               "traffic": {"height": 64, "width": 128, "batch_pairs": 2,
                           "clip_frames": 6, "warmup_frames": 4,
                           "sample": 6}},
}
INFER_CELLS = ("unet_pairs_1080p_b32", "flow_pairs_1080p_b32",
               "unet_stream_2x_1080p")


def tiny(workload: str, root: str = ROOT) -> dict:
    from benchmark.harness import cell as cells

    kind = cells.load(workload, root).traffic["kind"]
    return {k: dict(v) for k, v in TINY[kind].items()}
