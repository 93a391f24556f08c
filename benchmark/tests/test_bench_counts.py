"""The FLOP and byte counts against hand counts at small shapes, and the
production configurations' totals."""

from __future__ import annotations

import os

import pytest

from benchmark.counts import flow, peaks, unet
from benchmark.harness import cell as cells
from benchmark.harness.cell import load_file
from benchmark.tests.sizes import ROOT


def _counts(name):
    return load_file(os.path.join(ROOT, "benchmark", "counts", f"{name}.py"))


def test_head_counts_by_hand():
    head = _counts("refine_head")
    # 1 pair of 2x3 pixels, gray, the prediction and 2 planes, width 4
    flops, f32_flops, byts = head.flops_bytes(1, 2, 3, 1, 3, width=4)
    px = 6
    macs = px * (9 * 3 * 4 + 9 * 4 * 4 + 4 * 1)      # conv1, conv2, out
    assert flops == 2 * macs and f32_flops == 0
    weights = 2 * (9 * 3 * 4 + 4 + 9 * 4 * 4 + 4) + 4 * (4 + 1)
    assert byts == px * (4 + 2 * 2 + 2) + weights   # f32 pred, bf16 planes
    # two of the planes in f32 (the flow head's warps)
    _, _, b32 = head.flops_bytes(1, 2, 3, 1, 5, width=4, nf32=2)
    assert b32 - px * (4 + 4 * 2 + 2 * 2 + 2) == \
        2 * (9 * 5 * 4 + 4 + 9 * 4 * 4 + 4) + 4 * (4 + 1)


def test_sampler_counts_by_hand():
    flops, byts = _counts("sample_fused").flops_bytes(2, 2, 3, 1)
    px = 12
    assert flops == px * (2 * (9 + 12) + 6 + 4)
    # bf16 f1, f2; f32 field (2), mask; f32 out, g0, g1; f32 t a pair
    assert byts == px * (2 * 2 + 8 + 4 + 12) + 4 * 2


def test_core_counts_by_hand():
    # depth 1, base 2: inc (cin 3 -> 2 -> 2), down1 (2 -> 2 -> 2, halved
    # at the bottom from 4), up1 over cat(skip 2, up 2) -> mid 2 -> 2, out
    h, w = 4, 6
    got = unet.core_flops(3, 5, 2, 1, h, w)
    full, quarter = h * w, (h // 2) * (w // 2)
    want = 2 * 9 * (full * (3 * 2 + 2 * 2) + quarter * (2 * 2 + 2 * 2)
                    + full * (4 * 2 + 2 * 2)) + 2 * full * 2 * 5
    assert got == want


def test_production_totals():
    u = cells.load("unet_pairs_1080p_b32", ROOT)
    f = cells.load("flow_pairs_1080p_b32", ROOT)
    assert unet.forward_flops(u.model, 1080, 1920) == pytest.approx(
        325.41e9, rel=1e-4)
    assert flow.forward_flops(f.model, 1080, 1920) == pytest.approx(
        52.69e9, rel=1e-3)
    assert unet.padded(u.model, 1080, 1920) == (1088, 1920)


def test_bound():
    assert peaks.bound_ms(989e9, 0) == pytest.approx(1.0)
    assert peaks.bound_ms(0, 3.35e9) == pytest.approx(1.0)
    assert peaks.bound_ms(0, 0, f32_flops=67e9) == pytest.approx(1.0)


def test_pair_counts_for_several_inbetweens():
    """The U-Net bisects (3 forwards for 2 or 3 in-betweens); the flow
    family passes the motion U-Net once and samples each time."""
    u = cells.load("unet_pairs_1080p_b32", ROOT).model
    f = cells.load("flow_pairs_1080p_b32", ROOT).model
    one = unet.forward_flops(u, 64, 96)
    assert [unet.pair_flops(u, 64, 96, n) for n in (1, 2, 3, 4)] == \
        [one, 3 * one, 3 * one, 7 * one]
    motion, sample = flow.motion_flops(f, 64, 96), flow.sample_flops(f, 64, 96)
    assert flow.forward_flops(f, 64, 96) == motion + sample
    assert flow.pair_flops(f, 64, 96, 3) == motion + 3 * sample
