"""Time the flow sampler and the SSIM kernel of several trees in one run.

    python3 scripts/torch_sampler_ssim_ab.py TREE [TREE ...] [--out FILE]

Each TREE is a checkout of the repo (``.`` for this one; an earlier commit
unpacked with ``git archive <commit>`` into ``build/parent``, which git
ignores). The trees are timed in the order given, each in a process of its
own, so ``build/parent . . build/parent`` alternates two trees on one card.
Each process imports the port's package from its tree, builds that tree's
``sample_fused`` and ``ssim_eval`` sources, and times them with THIS repo's
``chip_smoke.time_sampler`` and ``time_ssim`` (the same inputs and timing
for every tree; an older tree's own smoke records no ``device_ms``): the
sampler at 1 and 8 x 1088x1920 gray bf16, max_flow
16; the SSIM at 8x256x256, 8x1080x1920 and 1x2160x3840 uint8. Each number
is ``ms`` (CUDA events over back-to-back wrapper calls) and ``device_ms``
(the kernels' own device time, torch.profiler), beside the bound and the
plain version's time. Prints one line per timing and a JSON line with all
of them, and writes that JSON to ``--out``. Needs the card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLER_BATCHES = (1, 8)
SSIM_SHAPES = ((8, 256, 256), (8, 1080, 1920), (1, 2160, 3840))


def time_tree(tree: str) -> dict:
    """In a child process: build and time the tree's kernels."""
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location(
        "smoke_timing", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from ai_based_frame_interpolation_torch.ops import _build

    _build.build(["sample_fused", "ssim_eval"])
    for name, log in _build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)
    smi = smoke.card()
    out = {"card": smi}
    for b in SAMPLER_BATCHES:
        out[f"sample_fused_{b}x1088x1920"] = smoke.time_sampler(smi, b)
    for b, h, w in SSIM_SHAPES:
        out[f"ssim_eval_{b}x{h}x{w}"] = smoke.time_ssim(smi, b, h, w)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("trees", nargs="+")
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "sampler_ssim_ab.json"))
    p.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(time_tree(args.trees[0])), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        tree = os.path.abspath(tree)
        print(f"== {tree}", flush=True)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [tree] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree],
            cwd=tree, env=env, capture_output=True, text=True, check=False)
        lines = proc.stdout.splitlines()
        print("\n".join(l for l in lines if not l.startswith("RESULT ")),
              flush=True)
        if proc.returncode:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            return proc.returncode
        result = json.loads(next(l for l in lines
                                 if l.startswith("RESULT "))[7:])
        runs.append({"tree": os.path.relpath(tree, ROOT), **result})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(runs, f, indent=1)
    print(json.dumps(runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
