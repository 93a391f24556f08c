"""The port's plain flow sampler and shifts warp vs the JAX package's.

``sample_fused_reference`` is held against the Pallas kernel
``sample_fused`` in interpret mode (as ``tests/test_warp_fused.py`` runs it
on the CPU) and against the XLA shifts warp plus the blend, at the shapes
of ``tests/test_warp_fused.py``: odd sizes, RGB, and flows drawn out to
1.5x the displacement bound so the clamp is exercised. Tolerance 1e-5: both
sides compute the same two-tap lerps in f32, and the Pallas kernel in
interpret mode may contract a product and a sum that the port keeps apart
(one f32 ulp of values of order 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.ops.warp import backward_warp
from ai_based_frame_interpolation_torch.ops.warp_fused import (
    eligible, sample_fused, sample_fused_reference)
from ai_based_frame_interpolation_tpu.ops.pallas.warp_fused import (
    sample_fused as j_sample_fused)
from ai_based_frame_interpolation_tpu.ops.warp import (
    backward_warp as j_backward_warp)


def _inputs(shape, rmax, ts, seed=42):
    b, h, w, c = shape
    rng = np.random.default_rng(seed)
    f1 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    f2 = rng.standard_normal((b, h, w, c)).astype(np.float32)
    flow = rng.uniform(-1.5 * rmax, 1.5 * rmax, (b, h, w, 2)).astype(
        np.float32)
    mask = rng.uniform(0, 1, (b, h, w, 1)).astype(np.float32)
    return f1, f2, flow, mask, np.asarray(ts, np.float32)


def _xla_sample(f1, f2, flow, mask, t, rmax):
    """The JAX XLA route: two shifts warps and the blend of models/flow.py."""
    tb = t[:, None, None, None]
    g0 = np.asarray(j_backward_warp(jnp.asarray(f1), jnp.asarray(-tb * flow),
                                    impl="shifts", max_flow=rmax))
    g1 = np.asarray(j_backward_warp(jnp.asarray(f2),
                                    jnp.asarray((1.0 - tb) * flow),
                                    impl="shifts", max_flow=rmax))
    w0 = (1 - tb) * mask
    w1 = tb * (1 - mask)
    return (w0 * g0 + w1 * g1) / (w0 + w1 + 1e-6), g0, g1


def _port(args, rmax):
    return [p.numpy() for p in sample_fused_reference(
        *(torch.from_numpy(a) for a in args), max_flow=rmax)]


@pytest.mark.parametrize("shape,rmax,ts", [
    ((2, 72, 160, 1), 8, [0.5, 0.25]),
    ((1, 129, 257, 1), 8, [0.33]),      # non-multiple H and W
    ((1, 16, 128, 1), 4, [0.5]),
    ((2, 72, 160, 3), 8, [0.5, 0.3]),   # RGB
])
def test_reference_matches_pallas_interpret_and_xla(shape, rmax, ts):
    args = _inputs(shape, rmax, ts)
    got = _port(args, rmax)
    want = j_sample_fused(*(jnp.asarray(a) for a in args), max_flow=rmax,
                          interpret=True)
    for g, w, x in zip(got, want, _xla_sample(*args, rmax)):
        assert g.dtype == np.float32 and g.shape == shape
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-5)
        np.testing.assert_allclose(g, x, rtol=0, atol=1e-5)


def test_narrow_frames_match_xla_shifts():
    """Widths below the JAX kernel's 2*max_flow + 2 (here 9x7 RGB at
    max_flow 4): the port's sampler has no width bound; JAX takes its XLA
    route there."""
    shape, rmax = (2, 9, 7, 3), 4
    args = _inputs(shape, rmax, [0.4, 0.9], seed=7)
    assert eligible(TConfig(arch="flow", max_flow=rmax), shape)
    for g, x in zip(_port(args, rmax), _xla_sample(*args, rmax)):
        np.testing.assert_allclose(g, x, rtol=0, atol=1e-5)


def test_backward_warp_reads_x_at_the_source_row():
    # one row shifted by a constant y displacement: the x displacement that
    # applies is the one stored at the source row, not at the output row
    img = np.arange(4 * 6, dtype=np.float32).reshape(1, 4, 6, 1)
    flow = np.zeros((1, 4, 6, 2), np.float32)
    flow[..., 1] = 1.0                  # read one row down
    flow[0, 2, :, 0] = 2.0              # x shift stored at row 2 only
    out = backward_warp(torch.from_numpy(img), torch.from_numpy(flow),
                        max_flow=4).numpy()
    # output row 1 reads source row 2, shifted by 2 and edge-clamped; the
    # other rows read unshifted rows one down, the last one clamped
    np.testing.assert_array_equal(out[0, 1, :, 0], [14, 15, 16, 17, 17, 17])
    np.testing.assert_array_equal(out[0, 0, :, 0], img[0, 1, :, 0])
    np.testing.assert_array_equal(out[0, 3, :, 0], img[0, 3, :, 0])


@pytest.mark.parametrize("impl", ["gather4", "patch", "pyramid"])
def test_other_warps_are_not_ported(impl):
    img = torch.zeros(1, 4, 4, 1)
    with pytest.raises(NotImplementedError, match="ROADMAP Queue A item 8"):
        backward_warp(img, torch.zeros(1, 4, 4, 2), impl=impl)


def test_eligible():
    cfg = TConfig(arch="flow", max_flow=16)
    assert eligible(cfg, (8, 1088, 1920, 1))
    assert eligible(cfg, (2, 72, 160, 3))
    assert not eligible(cfg, (1, 72, 160, 2))
    assert not eligible(cfg, (1, 1, 160, 1))
    assert not eligible(TConfig(arch="flow", flow_bidir=True), (1, 8, 8, 1))
    assert not eligible(TConfig(arch="flow", warp_impl="pyramid"),
                        (1, 8, 8, 1))


def test_cpu_wrapper_runs_the_plain_version_without_launching():
    args = [torch.from_numpy(a) for a in _inputs((2, 24, 40, 1), 8,
                                                 [0.5, 0.2])]
    args[0], args[1] = args[0].bfloat16(), args[1].bfloat16()
    before = sample_fused.launches
    got = sample_fused(*args, max_flow=8)
    want = sample_fused_reference(*args, max_flow=8)
    assert sample_fused.launches == before
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        assert torch.equal(g, w)
