"""A video stream: ``interpolate_video_frames`` at ``factor`` and
``batch_pairs`` over a clip of ``clip_frames`` in host memory, cycled
without end, the output read frame by frame. Every output frame is an
answer: output ``j = i factor + q`` is input frame ``i`` where ``q`` is 0,
else the ``q``-th in-between of input frames ``i`` and ``i + 1`` (the clip
cycled), which the originals' bytes and the reference's in-betweens
judge."""

from __future__ import annotations

from torch.profiler import record_function

from benchmark.harness import frames, infer


class Stream(infer.Kind):

    def inputs(self, cell, seed, device):
        t = cell.traffic
        return list(frames.clip(seed, t["clip_frames"], t["height"],
                                t["width"], t["channels"], t["motion_px"],
                                device))

    def entry(self, engine):
        return engine.interpolate_video_frames

    def drive(self, cell, clip, keep, device, run):
        t = cell.traffic
        f, n = t["factor"], len(clip)

        def forever():
            i = 0
            while True:
                yield clip[i % n]
                i += 1

        gen = run(forever(), f, t["batch_pairs"])
        state = {"j": 0}
        for _ in range(t["warmup_frames"]):
            next(gen)
            state["j"] += 1
        infer.sync(device)
        start = state["j"]

        def step():
            for _ in range(f):
                with record_function("bench.next_frame"):
                    frame = next(gen)
                with record_function("bench.keep"):
                    keep.offer(state["j"], frame)
                state["j"] += 1
            return f

        def finish():
            gen.close()
            pairs = (state["j"] - start) / f
            return {"pairs": pairs, "dispatches": pairs / t["batch_pairs"]}

        return step, finish

    def cases(self, cell, kept, clip):
        f, n = cell.traffic["factor"], len(clip)
        originals, mids = [], []
        for j, got in kept:
            i, q = divmod(j, f)
            if q == 0:
                originals.append((got, clip[i % n]))
            else:
                mids.append((got, clip[i % n], clip[(i + 1) % n], q - 1,
                             f - 1))
        return mids, originals

    def n_out(self, cell):
        return cell.traffic["factor"] - 1

    def launch_batch(self, cell):
        return cell.traffic["batch_pairs"]


run = Stream().run
