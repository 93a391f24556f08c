"""The plain references against the port's CPU path at tiny sizes: in
float32 both compute the same model, so they agree to rounding, for one
in-between and for several (the U-Net's bisection, the flow family's
exact times)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness import cell as cells
from benchmark.harness import frames, infer
from benchmark.harness import weights as weight_gen
from benchmark.tests.sizes import ROOT


def _f32(workload):
    cell = cells.load(workload, ROOT, {"model": {"base_width": 8,
                                                 "refine_width": 8}})
    cell.config["compute_dtype"] = "float32"
    w = weight_gen.make(cell.reference().leaves(cell.model),
                        cell.config["init"], 11, "cpu")
    return cell, w, infer.build_engine(cell, w, "cpu")


def _close(got, want):
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and diff.mean() < 1e-3


@pytest.mark.parametrize("workload", ["unet_pairs_1080p_b32",
                                      "flow_pairs_1080p_b32"])
def test_midpoints_match_the_port_in_f32(workload):
    cell, w, engine = _f32(workload)
    f1, f2 = frames.pairs(12, 2, 40, 72, 1, 4, "cpu")
    got = engine.interpolate_batch(f1, f2)
    want = cell.reference().inbetweens(w, torch.from_numpy(f1),
                                       torch.from_numpy(f2), cell.model)
    assert want.shape == (2, 1, 40, 72, 1)
    _close(got, want[:, 0].numpy())


@pytest.mark.parametrize("workload", ["unet_pairs_1080p_b32",
                                      "flow_pairs_1080p_b32"])
@pytest.mark.parametrize("factor", [3, 4])
def test_stream_inbetweens_match_the_port_in_f32(workload, factor):
    """A stream at ``factor``: the kind's cases, answered by the
    reference, against the port's output frames."""
    cell, w, engine = _f32(workload)
    clip = frames.clip(13, 3, 40, 72, 1, 4, "cpu")
    out = list(engine.interpolate_video_frames(iter(clip), factor, 2))
    assert len(out) == (len(clip) - 1) * factor + 1
    cell.traffic.update(kind="stream", factor=factor)
    mids, originals = cells.kind(cell).Stream().cases(
        cell, list(enumerate(out)), list(clip))
    assert len(mids) == (len(clip) - 1) * (factor - 1)
    assert all(np.array_equal(a, b) for a, b in originals)
    want = infer.reference_frames(cell, w, mids, "cpu")
    for (got, *_), ref in zip(mids, want):
        _close(got, ref)


def test_judge_counts_pixels_off_by_three():
    a = np.zeros((2, 4, 1), np.uint8)
    b = a.copy()
    b[0, :2] = 3
    b[1, 0] = 2
    out = infer.judge([a], [b], None)
    assert out["worst_frame_off3_pct"] == pytest.approx(25.0)
    out = infer.judge([a], [a], [(a, a), (a, b)])
    assert out["originals_mismatched"] == 1
