"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; its
configuration, traffic mix, limits and per-layer metrics are files under
``benchmark/`` found by name (``benchmark/README.md``). With ``--trace
0`` the last line of standard output is one JSON object with the cell's
end-to-end metrics; with ``--trace 1`` the window runs under
``torch.profiler`` and the metrics are the cell's per-layer ones, with
the device's busy and window seconds and a breakdown. Either way the
answers of the window are compared with the plain reference, and each
number compared is printed beside its limit, last on standard error and
under ``check`` in the result. Without the CUDA cards the cell asks for,
it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cells  # noqa: E402
from benchmark.harness import env  # noqa: E402


class Reading:
    """What a metric's reader sees: the cell, the traced window's summary
    (``trace.summarize``; None with ``--trace 0``) and the run's record
    (``setup_s``, ``window_s``, the work done in the window: ``answers``,
    ``pairs``, ``dispatches``, a pair cell's ``call_ms``; and whatever
    else the cell's kind records)."""

    def __init__(self, cell, summary: dict, record: dict):
        self.cell = cell
        self.trace = summary
        self.record = record

    def counts(self, name=None):
        return self.cell.counts(name)


def check(cell, judged: dict) -> dict:
    """Each number compared, beside its limit."""
    return {name: {"value": judged[name], "limit": limit}
            for name, limit in cell.limits.items()}


def result(cell, record: dict, trace: bool, device_info: dict,
           readers=None) -> dict:
    """The result line of one run: with ``trace`` the cell's per-layer
    metrics, else its end-to-end ones, each read by ``metrics/<name>.py``
    (``readers``, by default loaded)."""
    checked = check(cell, record["judged"])
    correct = all(c["value"] <= c["limit"] for c in checked.values()) \
        and record.get("failed", 0) == 0
    metrics = {}
    device = dict(device_info)
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record.get("failed", 0), "metrics": metrics,
           "device": device}
    summary = record.get("summary") if trace else None
    if trace and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    if not trace or summary is not None:
        readers = readers or cells.readers(cell, trace)
        ctx = Reading(cell, summary, record)
        for m in cell.per_layer if trace else cell.end_to_end:
            value = readers[m["name"]].read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out["check"] = checked
    return out


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device=None, root: str = ROOT, overrides=None, fault=None,
             t_start: float = T_START) -> dict:
    """One run of ``workload`` by its traffic's kind
    (``kinds/<kind>.py``): (record, cell). ``device`` is the card unless a
    test names the CPU; ``overrides`` and ``fault`` are the tests'."""
    cell = cells.load(workload, root, overrides)
    record = cells.kind(cell).run(cell, seed, seconds, trace,
                                  device or "cuda", t_start, fault=fault)
    return record, cell


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    env.set_caches(ROOT)

    import torch

    cell = cells.load(args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch sees {have}. No result.", file=sys.stderr)
        return 2
    record, cell = run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace))
    found = env.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    limits = env.power_limits()
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": cell.chips,
            "memory_peak_bytes": record["memory_peak_bytes"],
            "power_limit_w": limits[0] if limits else None}
    out = result(cell, record, bool(args.trace), info)
    print(json.dumps({"clocks_beside_window": record.get("clocks"),
                      "rate_by_quarter": record.get("quarters"),
                      "judged": record["judged"]}), flush=True)
    for name, c in out["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
