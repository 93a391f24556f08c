"""The control comes out not correct: the reference with every
convolution's operands rounded to fp8, put in the program's place, reads
above each image cell's limit, while the program reads below it; at the
published widths, on frames the CPU holds."""

from __future__ import annotations

import time

import pytest

from benchmark.harness import cell as cells
from benchmark.tests.sizes import ROOT

SMALL = {"height": 128, "width": 192, "batch": 2, "pool_batches": 1,
         "sample": 2, "warmup_calls": 0}


@pytest.mark.parametrize("workload", ["unet_pairs_1080p_b32",
                                      "flow_pairs_1080p_b32"])
@pytest.mark.parametrize("seed", [2 ** 31 + 5, 2 ** 31 + 6])
def test_control_fails_the_limit(workload, seed):
    cell = cells.load(workload, ROOT, {"traffic": SMALL})
    rec = cells.kind(cell).run(cell, seed, 0.1, False, "cpu",
                               time.perf_counter(), control=True)
    limit = cell.limits["worst_frame_off3_pct"]
    assert rec["judged"]["worst_frame_off3_pct"] <= limit
    assert rec["control"]["worst_frame_off3_pct"] > limit


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["unet_pairs_1080p_b32",
                                      "flow_pairs_1080p_b32",
                                      "unet_stream_2x_1080p"])
def test_control_at_the_cells_size(workload):
    """On the card, at the cell's own size and load: one seed's short
    window, the program under the limit and the control over it."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = cells.load(workload, ROOT)
    rec = cells.kind(cell).run(cell, 2 ** 31 + 101, 2.0, False, "cuda",
                               time.perf_counter(), control=True)
    limit = cell.limits["worst_frame_off3_pct"]
    assert rec["judged"]["worst_frame_off3_pct"] <= limit
    assert rec["control"]["worst_frame_off3_pct"] > limit
