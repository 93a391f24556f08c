"""A run with its timed path broken underneath comes out not correct:
each fault that a cell can have, at a tiny size on the CPU (the look for
a card skipped), beside the sound run, which comes out correct."""

from __future__ import annotations

import time

import pytest

from benchmark import run as bench_run
from benchmark.tests import faults
from benchmark.tests.sizes import ROOT, tiny

CASES = [("unet_pairs_1080p_b32", None), ("unet_pairs_1080p_b32",
                                          faults.swap_answers),
         ("flow_pairs_1080p_b32", None), ("flow_pairs_1080p_b32",
                                          faults.swap_answers),
         ("unet_stream_2x_1080p", None), ("unet_stream_2x_1080p",
                                          faults.shifted_inbetween)]


def _correct(workload, fault, seconds=0.5, root=ROOT):
    """The result of a tiny run of ``workload`` with ``fault`` planted."""
    record, cell = bench_run.run_cell(workload, 2 ** 31 + 77, seconds, False,
                                      "cpu", root=root,
                                      overrides=tiny(workload), fault=fault,
                                      t_start=time.perf_counter())
    return bench_run.result(cell, record, False, {"platform": "cpu"})


@pytest.mark.parametrize("workload,fault", CASES,
                         ids=[f"{w}-{f.__name__ if f else 'sound'}"
                              for w, f in CASES])
def test_inference_fault(workload, fault):
    out = _correct(workload, fault)
    assert out["correct"] is (fault is None), out["check"]

