"""Independent pairs: one caller in a closed loop, each call
``interpolate_batch`` over ``batch`` pairs from a pool of ``pool_batches``
distinct batches in host memory, cycled in an order drawn from the seed.
Each call's wall time is read from the host's clock (``call_ms``); every
answer is an in-between, the midpoint of its pair."""

from __future__ import annotations

import time

import numpy as np
from torch.profiler import record_function

from benchmark.harness import frames, infer


class Pairs(infer.Kind):

    def inputs(self, cell, seed, device):
        t = cell.traffic
        h, w, c = t["height"], t["width"], t["channels"]
        b, pool = t["batch"], t["pool_batches"]
        f1, f2 = frames.pairs(seed, b * pool, h, w, c, t["motion_px"],
                              device)
        return (f1.reshape(pool, b, h, w, c), f2.reshape(pool, b, h, w, c))

    def entry(self, engine):
        return engine.interpolate_batch

    def drive(self, cell, inputs, keep, device, call):
        t = cell.traffic
        f1, f2 = inputs
        b, pool = t["batch"], t["pool_batches"]
        order = np.random.default_rng(keep.rng.integers(2 ** 62)) \
            .permutation(pool)
        for i in range(t["warmup_calls"]):
            call(f1[order[i % pool]], f2[order[i % pool]])
        infer.sync(device)
        call_ms = []

        def step():
            k = int(order[len(call_ms) % pool])
            t0 = time.perf_counter()
            with record_function("bench.call"):
                out = call(f1[k], f2[k])
            call_ms.append((time.perf_counter() - t0) * 1e3)
            with record_function("bench.keep"):
                for i in range(b):
                    keep.offer((k, i), out[i])
            return b

        def finish():
            return {"call_ms": call_ms, "dispatches": len(call_ms),
                    "pairs": b * len(call_ms)}

        return step, finish

    def cases(self, cell, kept, inputs):
        f1, f2 = inputs
        return [(got, f1[k][i], f2[k][i], 0, 1) for (k, i), got in kept], \
            None

    def n_out(self, cell):
        return 1

    def launch_batch(self, cell):
        return cell.traffic["batch"]


run = Pairs().run
