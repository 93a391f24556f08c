"""The readers of the port's spans: on a made-up table, on a program
without the table, and after a tiny traced run on the CPU, whose window
alone the table holds."""

from __future__ import annotations

import pytest

from benchmark.harness import cell as cells
from benchmark.tests.sizes import tiny

SPANS = {"upload_ms_per_dispatch": "engine.upload",
         "enqueue_ms_per_dispatch": "engine.enqueue",
         "download_ms_per_dispatch": "engine.download",
         "interleave_ms_per_dispatch": "stream.interleave"}


def _readers():
    cell = cells.load("unet_stream_2x_1080p")
    readers = cells.readers(cell)
    assert set(SPANS) <= set(readers)
    return {name: readers[name] for name in SPANS}


def test_readers_on_a_made_up_table(monkeypatch):
    from ai_based_frame_interpolation_torch.utils import profiling

    table = {span: {"count": 4, "seconds": 0.002 * (i + 1),
                    "self_seconds": 0.001}
             for i, span in enumerate(SPANS.values())}
    monkeypatch.setattr(profiling, "totals", lambda: table)
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"engine.dispatches": 4})
    for i, (name, reader) in enumerate(_readers().items()):
        assert reader.read(None) == pytest.approx(0.5 * (i + 1)), name
    monkeypatch.setattr(profiling, "counters", lambda: {})
    assert all(r.read(None) is None for r in _readers().values())
    monkeypatch.setattr(profiling, "counters",
                        lambda: {"engine.dispatches": 4})
    monkeypatch.setattr(profiling, "totals", lambda: {})
    assert all(r.read(None) is None for r in _readers().values())


def test_readers_on_a_program_without_the_table(monkeypatch):
    """The parent of the spans: a profiling module with no table."""
    from ai_based_frame_interpolation_torch.utils import profiling

    monkeypatch.delattr(profiling, "totals")
    monkeypatch.delattr(profiling, "counters")
    assert all(r.read(None) is None for r in _readers().values())


@pytest.mark.parametrize("workload", ["unet_pairs_1080p_b32",
                                      "unet_stream_2x_1080p"])
def test_a_traced_run_leaves_its_window_in_the_table(workload):
    from ai_based_frame_interpolation_torch.utils import profiling
    from benchmark import run as bench_run

    profiling.reset()           # the window of an earlier run in this process
    record, cell = bench_run.run_cell(workload, 2 ** 31 + 77, 0.3, True,
                                      "cpu", overrides=tiny(workload))
    n = profiling.counters()["engine.dispatches"]
    if cell.traffic["kind"] == "pairs":
        assert n == record["dispatches"]
    else:       # a batch is in flight at each end of the window
        assert abs(n - record["dispatches"]) <= 1
    got = {name: r.read(None) for name, r in _readers().items()}
    want = set(SPANS) - ({"interleave_ms_per_dispatch"}
                         if cell.traffic["kind"] == "pairs" else set())
    assert {k for k, v in got.items() if v is not None} == want
    assert all(got[k] > 0 for k in want)
