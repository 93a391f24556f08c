"""The port's engine and batcher vs the JAX engine, on the CPU.

Both engines run in f32 on the same bridged weights (drawn from numpy,
BatchNorm statistics included, then folded on each side) and the same
uint8 frames; their uint8 outputs agree within 1 LSB, the repo's
cross-program tolerance (f32 sums in another order can move a value that
sits on a rounding boundary).
"""

import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_based_frame_interpolation_torch.config import ModelConfig as TConfig
from ai_based_frame_interpolation_torch.infer.engine import (
    InterpolationEngine as TEngine)
from ai_based_frame_interpolation_torch.serve.batcher import DynamicBatcher
from ai_based_frame_interpolation_tpu.config import ModelConfig as JConfig
from ai_based_frame_interpolation_tpu.infer.engine import (
    InterpolationEngine as JEngine)
from ai_based_frame_interpolation_tpu.models import build_model as j_build
from test_torch_unet import CASES, random_variables


def _engines(case):
    kw, hw = CASES[case]
    variables = random_variables(kw, hw)
    jeng = JEngine(j_build(JConfig(**kw), jnp.float32), variables,
                   compute_dtype=jnp.float32)
    teng = TEngine.from_flax_variables(variables, TConfig(**kw),
                                       compute_dtype=torch.float32,
                                       device="cpu")
    return jeng, teng


def _pairs(n, h, w, seed=0):
    gen = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = 127 + 80 * np.sin(x / 5.0) * np.cos(y / 4.0)
    f1 = np.stack([np.clip(base + gen.normal(0, 20, base.shape), 0, 255)
                   for _ in range(n)]).astype(np.uint8)[..., None]
    return f1, np.roll(f1, 3, axis=2)


def _within_1lsb(a, b):
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    assert int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max()) <= 1


@pytest.mark.parametrize("case", ["parity", "production"])
def test_engine_matches_jax(case):
    jeng, teng = _engines(case)
    f1, f2 = _pairs(2, 50, 60)       # not a multiple of the pad size
    _within_1lsb(teng.interpolate_batch(f1, f2), jeng.interpolate_batch(f1, f2))
    got = teng.generate_intermediate_frames(f1[0], f2[0], num=3)
    want = jeng.generate_intermediate_frames(f1[0], f2[0], num=3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _within_1lsb(g, w)


def test_chunked_dispatch_matches_monolithic():
    eng = TEngine.random_init(TConfig(**CASES["production"][0]), seed=0,
                              compute_dtype=torch.float32, device="cpu")
    f1, f2 = _pairs(5, 32, 48, seed=1)
    whole = eng.interpolate_batch(f1, f2)
    eng.max_dispatch_batch = 2       # chunks of 2, 2 and a tail of 1
    eng._fn_cache.clear()
    _within_1lsb(eng.interpolate_batch(f1, f2), whole)


def test_batcher_answers_concurrent_requests():
    eng = TEngine.random_init(TConfig(**CASES["production"][0]), seed=0,
                              compute_dtype=torch.float32, device="cpu")
    batcher = DynamicBatcher(eng, max_batch=4)
    f1, f2 = _pairs(8, 32, 48, seed=2)
    results = [None] * 8
    # the first dispatch holds the engine until the other 7 requests wait
    gate = threading.Event()
    pair_fn = eng._pair_fn

    def held_pair_fn(n_out, depth):
        fn = pair_fn(n_out, depth)

        def run(*args):
            assert gate.wait(timeout=30)
            return fn(*args)

        return run

    eng._pair_fn = held_pair_fn

    def request(i):
        results[i] = batcher.generate_intermediate_frames(f1[i], f2[i],
                                                          1 + 2 * (i % 2))

    threads = [threading.Thread(target=request, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + 30
    while len(batcher._pending) < 7 and time.monotonic() < deadline:
        time.sleep(0.01)
    gate.set()
    for t in threads:
        t.join(timeout=60)
    eng._pair_fn = pair_fn
    assert not any(t.is_alive() for t in threads)
    for i, frames in enumerate(results):
        want = eng.generate_intermediate_frames(f1[i], f2[i], 1 + 2 * (i % 2))
        assert len(frames) == len(want)
        for g, w in zip(frames, want):
            _within_1lsb(g, w)
    stats = batcher.stats
    assert stats["batched_requests"] == 8
    assert stats["dispatches"] < 8 and stats["max_batch_seen"] > 1


def test_engine_without_a_card_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TEngine.random_init(TConfig(**CASES["production"][0]))


def test_each_entry_runs_its_dispatches_in_the_engine_spans(monkeypatch):
    """With the profiler's flag up, each dispatch of ``interpolate_batch``,
    ``generate_intermediate_frames``, the batcher and a 2x stream records
    one upload, enqueue and download, a stream batch one interleave;
    ``engine.dispatches`` counts them; the stream's spans are closed
    whenever it yields, so the consumer's span between two frames opens
    inside none of them. (The flag alone, not a profiler: starting the
    first session costs seconds of CPU; ``test_torch_utils.py`` runs the
    spans under real sessions.)"""
    from ai_based_frame_interpolation_torch.utils import profiling

    monkeypatch.setattr(torch.autograd.profiler, "_is_profiler_enabled",
                        True)

    eng = TEngine.random_init(TConfig(**CASES["production"][0]), seed=0,
                              compute_dtype=torch.float32, device="cpu")
    batcher = DynamicBatcher(eng, max_batch=4)
    f1, f2 = _pairs(5, 32, 48, seed=3)
    host = ("engine.upload", "engine.enqueue", "engine.download")

    def recorded(run):
        profiling.reset()
        run()
        return ({k: v["count"] for k, v in profiling.totals().items()},
                profiling.counters().get("engine.dispatches"))

    for run in (lambda: eng.interpolate_batch(f1[:2], f2[:2]),
                lambda: eng.generate_intermediate_frames(f1[0], f2[0], 3),
                lambda: batcher.interpolate_pair(f1[0], f2[0])):
        assert recorded(run) == (dict.fromkeys(host, 1), 1)
    assert batcher.stats["avg_queue_wait_ms"] >= 0
    batcher.close()

    def consume():
        for _ in eng.interpolate_video_frames(iter(f1), 2, batch_pairs=2):
            with profiling.annotate("consumer"):
                torch.ones(4).sum()

    got, n = recorded(consume)
    assert n == 2                                 # 4 pairs, 2 a batch
    assert got == {**dict.fromkeys(host + ("stream.interleave",), 2),
                   "consumer": 9}
    # a span with no span inside it has self seconds equal to its seconds
    for k, v in profiling.totals().items():
        assert v["self_seconds"] == v["seconds"], k
