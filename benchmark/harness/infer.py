"""What every traffic kind of the inference engine shares: set-up, the
measured window, and the comparison with the plain reference.

A kind (``benchmark/kinds/<kind>.py``, named by the traffic file's
``kind``) subclasses :class:`Kind` and says what is its own: how its
inputs are made, which public entry of the engine the window drives, how
one step of the window drives it, and which reference answer each kept
output stands for. :meth:`Kind.run` does the rest.

Set-up makes the weights and the traffic's inputs from the seed on the
device, builds the engine (``InterpolationEngine``, the configuration's
dtype, folding and core route), and lets the kind warm the cell's one
shape. The window then calls the kind's step for ``--seconds``.

A sample of the answers, drawn from the seed (a reservoir over every
answer of the window), is kept. Once the window has closed, the peak
memory has been read and the engine is freed, the reference computes
each sampled in-between from the same weights and inputs, and each answer
is judged: the share of its pixels three or more grey levels from the
reference's (the worst sampled frame is the number compared; the bf16
program rounds its inputs and outputs to within a grey level or two, an
fp8 computation spreads wider) and, where the kind passes originals
through, whether each sampled original is the input frame byte for byte.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np

from . import env
from . import trace as tracing
from . import weights as weight_gen

QUARTERS = 4        # the window's slices whose rates the diagnostic line shows


def seeds(seed: int):
    """Independent streams for the weights, the inputs and the sample."""
    return (2 * seed) % 2 ** 63, (2 * seed + 1) % 2 ** 63, seed


class Reservoir:
    """A uniform sample of ``k`` of the answers seen, drawn from the
    seed, copied into storage that set-up allocates and touches, so that
    keeping an answer costs the window one copy and no page faults."""

    def __init__(self, k: int, seed: int, shape: tuple):
        self.k = k
        self.rng = np.random.default_rng(seed)
        self.frames = np.ones((k, *shape), np.uint8)
        self.keys: List = []
        self.seen = 0

    def offer(self, key, frame: np.ndarray) -> None:
        if len(self.keys) < self.k:
            slot = len(self.keys)
            self.keys.append(key)
        else:
            slot = int(self.rng.integers(0, self.seen + 1))
            if slot >= self.k:
                self.seen += 1
                return
            self.keys[slot] = key
        np.copyto(self.frames[slot], frame)
        self.seen += 1

    @property
    def kept(self) -> List[tuple]:
        return [(key, self.frames[i]) for i, key in enumerate(self.keys)]


def build_engine(cell, weights, device):
    import torch

    from ai_based_frame_interpolation_torch.config import ModelConfig
    from ai_based_frame_interpolation_torch.infer.engine import (
        InterpolationEngine)
    from ai_based_frame_interpolation_torch.models import build_model

    cfg = ModelConfig(**cell.model)
    dtype = getattr(torch, cell.config["compute_dtype"])
    with torch.device(device):
        model = build_model(cfg, dtype)
    state = weight_gen.program_state(model, weights)
    return InterpolationEngine(model, state, dtype,
                               fold=cell.config["fold"], device=device,
                               core_impl=cell.config["core_impl"])


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _window(seconds: float, step: Callable[[], int], device) -> tuple:
    """Run ``step`` (returns answers done) until ``seconds`` have passed;
    (answers, window seconds, answers done in each quarter of it)."""
    import torch

    done, marks = 0, []
    with torch.profiler.record_function(tracing.WINDOW):
        t0 = time.perf_counter()
        while True:
            done += step()
            at = time.perf_counter() - t0
            marks.append((at, done))
            if at >= seconds:
                break
        sync(device)
        elapsed = time.perf_counter() - t0
    edges = [elapsed * (k + 1) / QUARTERS for k in range(QUARTERS)]
    upto = [max([d for a, d in marks if a <= e], default=0) for e in edges]
    upto[-1] = done
    quarters = [b - a for a, b in zip([0] + upto[:-1], upto)]
    return done, elapsed, quarters


OFF = 3      # grey levels from the reference at which a pixel counts off


def _diff(got: np.ndarray, want: np.ndarray) -> np.ndarray:
    return np.abs(got.astype(np.int16) - want.astype(np.int16))


def reference_frames(cell, weights, cases, device, q=None) -> List[np.ndarray]:
    """The reference's answer to each in-between case ``(got, f1, f2, k,
    n)``, the ``k``-th of ``n`` in-betweens of the pair, four pairs at a
    time; ``q`` rounds every convolution's operands (the control)."""
    import torch

    ref = cell.reference()
    out: List[Optional[np.ndarray]] = [None] * len(cases)
    for n in sorted({c[4] for c in cases}):
        at = [i for i, c in enumerate(cases) if c[4] == n]
        for s in range(0, len(at), 4):
            part = at[s:s + 4]
            a = torch.from_numpy(np.stack([cases[i][1] for i in part]))
            b = torch.from_numpy(np.stack([cases[i][2] for i in part]))
            got = ref.inbetweens(weights, a.to(device), b.to(device),
                                 cell.model, n, q=q).cpu().numpy()
            for row, i in enumerate(part):
                out[i] = got[row, cases[i][3]]
    return out


def judge(answers: List[np.ndarray], want: List[np.ndarray],
          originals) -> Dict[str, float]:
    """The numbers compared: the worst answer's share of pixels ``OFF`` or
    more grey levels from the reference, in %, and, where there are
    originals, the sampled ones that are not their input frame byte for
    byte."""
    off = [100.0 * float((_diff(a, b) >= OFF).mean())
           for a, b in zip(answers, want)]
    out = {"worst_frame_off3_pct": max(off) if off else float("inf"),
           "frames": len(off) + len(originals or ())}
    if originals is not None:
        out["originals_mismatched"] = sum(
            int(not np.array_equal(got, frame)) for got, frame in originals)
    return out


class Kind:
    """A traffic kind of the inference engine. A subclass gives:

    - ``inputs(cell, seed, device)``: the traffic's frames, in host memory;
    - ``entry(engine)``: the engine's public entry that the window drives;
    - ``drive(cell, inputs, keep, device, entry)``: warm the cell's shape,
      then return ``(step, finish)``: ``step()`` drives the entry once and
      returns the answers it handed back, each offered to ``keep``;
      ``finish()`` returns what the record needs of the window:
      ``pairs`` (pairs interpolated), ``dispatches`` and anything of its
      own (``call_ms``);
    - ``cases(cell, kept, inputs)``: the kept answers as in-between cases
      ``(got, f1, f2, k, n)`` (the ``k``-th of ``n`` in-betweens of the
      pair ``f1``, ``f2``) and originals ``(got, input frame)``, or None
      where the kind returns none;
    - ``n_out(cell)``: the in-betweens a pair gets; ``launch_batch(cell)``:
      the pairs of one model launch.
    """

    def run(self, cell, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault: Optional[Callable] = None,
            control: bool = False) -> dict:
        """One run of the cell: the record that ``run.py`` reads."""
        import torch

        w_seed, f_seed, s_seed = seeds(seed)
        t = cell.traffic
        weights = weight_gen.make(cell.reference().leaves(cell.model),
                                  cell.config.get("init", {}), w_seed,
                                  device)
        engine = build_engine(cell, weights, device)
        keep = Reservoir(t["sample"], s_seed,
                         (t["height"], t["width"], t["channels"]))
        inputs = self.inputs(cell, f_seed, device)
        entry = self.entry(engine)
        if fault is not None:
            entry = fault(entry)
        step, finish = self.drive(cell, inputs, keep, device, entry)
        sync(device)
        setup_s = time.perf_counter() - t_start
        smi = [env.clocks()]
        prof = None
        if trace:
            seconds = min(seconds, t.get("trace_seconds", seconds))
            prof = tracing.profiler()
            prof.start()
        done, window_s, quarters = _window(seconds, step, device)
        if prof is not None:
            prof.stop()
        smi.append(env.clocks())
        extra = finish()
        summary = tracing.summarize(prof) if prof is not None else None
        cuda = torch.device(device).type == "cuda"
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        del engine, step, finish, entry
        if cuda:
            torch.cuda.empty_cache()
        kept = sorted(keep.kept, key=lambda kv: str(kv[0]))
        mids, originals = self.cases(cell, kept, inputs)
        want = reference_frames(cell, weights, mids, device)
        out = {"answers": done, "attempted": done, "window_s": window_s,
               "quarters": [q * QUARTERS / window_s for q in quarters],
               "n_out": self.n_out(cell),
               "launch_batch": self.launch_batch(cell),
               "setup_s": setup_s, "clocks": smi,
               "memory_peak_bytes": int(peak),
               "judged": judge([m[0] for m in mids], want, originals),
               "summary": summary, **extra}
        if control:
            from benchmark.reference.nets import fp8

            low = reference_frames(cell, weights, mids, device, q=fp8)
            out["control"] = judge(low, want, None)
        return out
