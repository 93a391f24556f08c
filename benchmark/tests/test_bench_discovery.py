"""The harness finds every piece of a cell by name, and a configuration,
traffic mix, traffic kind, end-to-end or per-layer metric and cell added
as new files and entries are found and run without an edit to any file
already there."""

from __future__ import annotations

import hashlib
import json
import os
import shutil

import pytest

from benchmark.harness import cell as cells
from benchmark.tests.sizes import INFER_CELLS, ROOT, TINY


def _spec(top):
    with open(os.path.join(top, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", INFER_CELLS)
def test_every_cell_resolves(workload):
    cell = cells.load(workload, ROOT)
    assert cell.family in ("unet", "flow")
    assert callable(cells.kind(cell).run)
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    for trace, metrics in ((True, cell.per_layer),
                           (False, cell.end_to_end)):
        readers = cells.readers(cell, trace)
        assert set(readers) == {m["name"] for m in metrics}
        assert all(callable(r.read) for r in readers.values())
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer
    assert cell.counts().forward_flops(cell.model, 64, 64) > 0
    assert cell.reference().leaves(cell.model)


def test_spec_shape():
    spec = _spec(ROOT)
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    names = [w["name"] for w in spec["workloads"]]
    assert len(names) == len(set(names))
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= 1
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            reported = e2e[m["moves"]].get("workloads", names)
            assert w in reported, (m["name"], w)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith("benchmark/")


def _hashes(top):
    out = {}
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".pyc"):
                continue
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, top)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return out


EXTRA_METRIC = '''"""A test per-layer metric: the pairs of the window."""


def read(ctx):
    return float(ctx.record["pairs"])
'''

EXTRA_END_TO_END = '''"""A test end-to-end metric: the calls a second of the window."""


def read(ctx):
    return ctx.record["dispatches"] / ctx.record["window_s"]
'''

EXTRA_KIND = '''"""A test kind: the pool's pairs handed to the engine in reverse
order, each answer judged against the reference's midpoint of that
order."""

from benchmark.kinds.pairs import Pairs


class Reversed(Pairs):

    def entry(self, engine):
        return lambda f1, f2: engine.interpolate_batch(f2, f1)

    def cases(self, cell, kept, inputs):
        mids, _ = super().cases(cell, kept, inputs)
        return [(got, b, a, k, n) for got, a, b, k, n in mids], None


run = Reversed().run
'''

NEW_CELLS = {
    # a new configuration and a new size of pairs: data files only
    "unet_w32_pairs_720p_b8": ("unet_w32", "pairs_720p_b8", "pairs"),
    # the stream at factor 4: a data file only
    "unet_stream_4x_1080p": ("unet_prod", "stream_4x_1080p", "stream"),
    # a new kind: a traffic file and the kind's code, a new file
    "flow_reversed_1080p_b32": ("flow_prod", "reversed_1080p_b32",
                                "pairs"),
}


def test_new_files_are_found(tmp_path):
    """A configuration, traffic mixes, a kind, an end-to-end and a
    per-layer metric, limits and cells, each new files or new entries in a
    copy, are found and run; every file of the copy that was there before
    is left as it was."""
    copy = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), copy / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = _hashes(copy / "benchmark")
    bench = copy / "benchmark"

    def write(rel, data):
        text = data if isinstance(data, str) else json.dumps(data)
        (bench / rel).write_text(text)

    def read(rel):
        return json.loads((bench / rel).read_text())

    cfg = read("configs/unet_prod.json")
    cfg["model"]["refine_width"] = 32
    write("configs/unet_w32.json", cfg)
    pairs = read("traffic/pairs_1080p_b32.json")
    write("traffic/pairs_720p_b8.json", dict(pairs, height=720, width=1280,
                                             batch=8))
    write("traffic/reversed_1080p_b32.json", dict(pairs, kind="reversed"))
    write("traffic/stream_4x_1080p.json",
          dict(read("traffic/stream_2x_1080p.json"), factor=4))
    write("kinds/reversed.py", EXTRA_KIND)
    write("metrics/pairs_seen.py", EXTRA_METRIC)
    write("metrics/calls_per_s.py", EXTRA_END_TO_END)
    spec = _spec(copy)
    spec["configs"].append({"name": "unet_w32", "source": "test",
                            "file": "benchmark/configs/unet_w32.json",
                            "reduced": ["refine_width"], "why": "test"})
    for name, (config, traffic, _) in NEW_CELLS.items():
        write(f"limits/{name}.json", {"worst_frame_off3_pct": 2.0})
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "test"})
    news = list(NEW_CELLS)
    spec["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                               "better": "higher", "bound": 0.1,
                               "source": "host_clock",
                               "workloads": news})
    spec["per_layer"].append({"name": "pairs_seen", "unit": "pairs",
                              "better": "higher", "source": "host_clock",
                              "layer": "test", "moves": "calls_per_s",
                              "workloads": news})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if m["name"] in ("output_fps", "mfu.infer"):
            m["workloads"] += news
    (copy / "BENCHMARK.json").write_text(json.dumps(spec))

    from benchmark import run as bench_run
    for name, (_, _, size) in NEW_CELLS.items():
        cell = cells.load(name, str(copy))
        assert {"pairs_seen", "mfu.infer"} <= set(cells.readers(cell))
        assert {"calls_per_s", "output_fps", "setup_s"} == \
            set(cells.readers(cell, trace=False))
        over = {k: dict(v) for k, v in TINY[size].items()}
        record, cell = bench_run.run_cell(name, 2 ** 31 + 21, 0.5, False,
                                          "cpu", str(copy), over)
        out = bench_run.result(cell, record, False, {"platform": "cpu"})
        assert out["correct"], (name, out["check"])
        assert {"calls_per_s", "output_fps", "setup_s"} == \
            set(out["metrics"])

        class Ctx:
            record = {"pairs": 7}
        assert cells.readers(cell)["pairs_seen"].read(Ctx()) == 7.0
    assert cells.load("unet_w32_pairs_720p_b8", str(copy)).model[
        "refine_width"] == 32
    after = _hashes(copy / "benchmark")
    assert {k: after[k] for k in before} == before
