"""Faults planted under the timed path, for the tests that see
``correct`` come out false. Each takes the program's entry and returns it
broken."""

from __future__ import annotations


def swap_answers(call):
    """``interpolate_batch`` with the first two answers of a call
    swapped."""
    def run(f1, f2):
        out = call(f1, f2).copy()
        out[[0, 1]] = out[[1, 0]]
        return out
    return run


def shifted_inbetween(stream):
    """``interpolate_video_frames`` with every in-between replaced by the
    original before it."""
    def run(frames, factor, batch_pairs):
        last = None
        for j, frame in enumerate(stream(frames, factor, batch_pairs)):
            if j % factor == 0:
                last = frame
                yield frame
            else:
                yield last
    return run

