"""Readings that set a cell's limits, on the chip; the benchmark's own
runs never run this.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        [--seconds 2] [--control]

For each seed, one run of the cell with a short window at the cell's own
load (``benchmark/run.py``'s run, all seeds in one process, the set-up
repeated per seed), printing the numbers compared of the program's
sampled answers and, with ``--control``, of the control put in the
program's place: the reference with the operands of every convolution
rounded to fp8 (e4m3, one scale a tensor), judged on the same sampled
inputs against the float32 reference. The program's readings give a limit's lower end, the control's its upper
one (``PERF.md``). One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    env.set_caches(ROOT)

    import torch

    from benchmark.harness import cell as cells

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    limits = env.power_limits()
    seeds = [int(s) for s in args.seeds.split(",")]
    card = torch.cuda.get_device_name(0)
    for seed in seeds:
        t0 = time.perf_counter()
        rec = cells.kind(cell).run(cell, seed, args.seconds, False, "cuda",
                                   t0, control=args.control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": rec["judged"],
                          "control": rec.get("control"),
                          "answers": rec["answers"],
                          "window_s": rec["window_s"],
                          "setup_s": rec["setup_s"], "card": card,
                          "power_limit_w": limits}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
