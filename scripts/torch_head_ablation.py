"""Where the fused refinement head's time goes: phases removed one at a time.

    python3 scripts/torch_head_ablation.py [--only NAME ...]

Copies the port into ``build/head_ablation/<name>/`` (ignored by git) once
per ablation, removes one phase of ``csrc/refine_head.cu``'s tile loop in
the copy by a text edit, builds every copy's kernel at once, and times the
head in each copy with its own ``chip_smoke.time_head`` (1x1088x1920 gray:
dense w64 with 3 planes, w16 with 5 planes of which 2 f32, depthwise w64),
the unedited copy (``base``) first. An ablated kernel computes a wrong
head: its times say what a phase costs, nothing else. Prints each kernel's
ptxas registers and spills, one line per time and a JSON line with all of
them. Needs the card and nvcc; each edit must match the source, or the
script stops before it builds anything.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = "ai_based_frame_interpolation_torch/csrc/refine_head.cu"
OUT = os.path.join(ROOT, "build", "head_ablation")
HEADS = {"w64": (64, 2, 0), "w16": (16, 4, 2), "dw64": (64, 2, 0, True)}
CONVERT = "    convert_halo(L, G, p, gt, H, W);\n"
STAGE = ("      stage_halo(L, G, ps, tile_xy(tile + stride, tiles_x, tiles_y), "
         "gt, H, W);\n")
# name -> [(text in the source, its replacement)]; "H < 0" is false at run
# time but unknown to the compiler, so the removed code is not folded away
ABLATIONS = {
    "base": [],
    "no_conv1": [("    switch (L.P) {", "    if (H < 0) switch (L.P) {")],
    "no_z1_store": [("      if (m < Z1_N) *reinterpret_cast",
                     "      if (m < Z1_N && H < 0) *reinterpret_cast")],
    "no_conv2": [("for (int tap = 0; tap < (DW ? 1 : 9); ++tap) {",
                  "for (int tap = 0; tap < (DW ? 1 : 9) * (H < 0); ++tap) {")],
    "no_halo": [(CONVERT, ""), (STAGE, "")],
    "no_convert": [(CONVERT, "")],
    "no_epilogue": [
        ("    store_rows(L, G.ostage, out, p, p.y0 + 2 * gw, lane, H, W);\n",
         ""),
        ("    for (int j = 0; j < NT; ++j) {\n      const float4 q0",
         "    for (int j = 0; j < NT * (H < 0); ++j) {\n      const float4 q0")],
    "no_dw_pass": [("      for (int x = 0; x < Z1_W; ++x) {",
                    "      for (int x = 0; x < Z1_W * (H < 0); ++x) {")],
    "one_group": [("make_plan<WD, DW>(nplanes, C, plane_f32, MAX_GROUPS);",
                   "make_plan<WD, DW>(nplanes, C, plane_f32, 1);")],
}

TIME = """
import json, chip_smoke as s
smi = s.card()
print(json.dumps({k: s.time_head(smi, *a)["ms"] for k, a in %r.items()}))
""" % (HEADS,)
BUILD = ("from ai_based_frame_interpolation_torch.ops import _build; "
         "_build.build(['refine_head']); "
         "print(_build.build_logs.get('refine_head', ''))")


def make_copies(names) -> None:
    with open(os.path.join(ROOT, SRC)) as f:
        source = f.read()
    edited = {}
    for name in names:
        text = source
        for old, new in ABLATIONS[name]:
            if old not in text:
                raise SystemExit(f"{name}: {old.strip()!r} is not in {SRC}")
            text = text.replace(old, new)
        edited[name] = text
    shutil.rmtree(OUT, ignore_errors=True)
    for name, text in edited.items():
        dst = os.path.join(OUT, name)
        shutil.copytree(os.path.join(ROOT, "ai_based_frame_interpolation_torch"),
                        os.path.join(dst, "ai_based_frame_interpolation_torch"),
                        ignore=shutil.ignore_patterns("_kernels", "__pycache__"))
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), dst)
        with open(os.path.join(dst, SRC), "w") as f:
            f.write(text)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--only", nargs="+", choices=sorted(ABLATIONS))
    args = p.parse_args(argv)
    names = ["base"] + [n for n in (args.only or ABLATIONS) if n != "base"]
    make_copies(names)
    builds = {n: subprocess.Popen([sys.executable, "-c", BUILD],
                                  cwd=os.path.join(OUT, n), text=True,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT) for n in names}
    for name, proc in builds.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(log)
            raise SystemExit(f"{name}: the build failed")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"{name}: {line.strip()}")
    times = {}
    for name in names:
        run = subprocess.run([sys.executable, "-c", TIME], text=True,
                             cwd=os.path.join(OUT, name), check=True,
                             capture_output=True)
        times[name] = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{name}: " + ", ".join(f"{k} {v:.4f} ms"
                                      for k, v in times[name].items()),
              flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "ms": times}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
