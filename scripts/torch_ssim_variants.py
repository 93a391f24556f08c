"""The SSIM kernel's geometry against its alternatives, in one run.

    python3 scripts/torch_ssim_variants.py [--out FILE]

Writes a copy of ``csrc/ssim_eval.cu`` per variant into
``build/ssim_variants/<name>/`` (ignored by git), edited by text
replacements, and builds each: ``port`` (the source as it is: 8 uint8
columns a lane, a grid of about 16 one-warp blocks an SM, bands of 2
rows or more, ux and uy by the exact FMA division), ``band4`` and
``band8`` (bands of 4 or 8 rows or more), ``shape64`` and
``shape128`` (64 or 128 bands a plane whatever the batch and the card),
``per_band`` (one partial a band, at the slot of its first row group,
in place of one every 2 rows: the bits then depend on the bands; the
partials start at zero, so the slots no band writes add nothing) and
``fdiv`` (ux and uy by ``__fdiv_rn``, as the first port divided). At
8x256x256, 8x1080x1920 and 1x2160x3840 gray uint8
(``chip_smoke.ssim_inputs``) it calls each library's C function on the
same inputs with the partials allocated once, holds the result within
``chip_smoke.SSIM_BOUND`` of the plain ``ssim_eval`` and bit for bit
across two runs, and times it by CUDA events over 20 launches and by
torch.profiler (both kernels' device time), each variant twice, in turns.
Prints one line per timing and a JSON line, and writes it to ``--out``.
Needs the card and nvcc; each edit must match the source, or the script
stops before it builds anything.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "build", "ssim_variants")
SRC = "ai_based_frame_interpolation_torch/csrc/ssim_eval.cu"
# the host's bands: as many as give about 16 blocks an SM
SM_RULE = ("const int bands = static_cast<int>(want < 1 ? 1 : "
           "(want > valid_h ? valid_h : want));")
# name -> [(text in the source, its replacement)]
VARIANTS = {
    "port": [],
    "band4": [("constexpr int MIN_BAND = 2;", "constexpr int MIN_BAND = 4;")],
    "band8": [("constexpr int MIN_BAND = 2;", "constexpr int MIN_BAND = 8;")],
    "shape64": [(SM_RULE, "const int bands = 64 < valid_h ? 64 : valid_h;")],
    "shape128": [(SM_RULE,
                  "const int bands = 128 < valid_h ? 128 : valid_h;")],
    "per_band": [("if ((row + 1) % GROUP == 0 || i == nin - 1) "
                  "flush(acc, out + row / GROUP);",
                  "if (i == nin - 1) flush(acc, out + oy0 / GROUP);")],
    "fdiv": [("EXACT_INT ? div49(sx) : __fdiv_rn(sx, n)", "__fdiv_rn(sx, n)"),
             ("EXACT_INT ? div49(sy) : __fdiv_rn(sy, n)", "__fdiv_rn(sy, n)")],
}
SHAPES = ((8, 256, 256), (8, 1080, 1920), (1, 2160, 3840))


def build() -> dict:
    from ai_based_frame_interpolation_torch.ops import _build

    with open(os.path.join(ROOT, SRC)) as f:
        source = f.read()
    edited = {}
    for name, edits in VARIANTS.items():
        text = source
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {SRC}")
            text = text.replace(old, new)
        edited[name] = text
    procs = {}
    for name, text in edited.items():
        os.makedirs(os.path.join(OUT, name), exist_ok=True)
        src = os.path.join(OUT, name, "ssim_eval.cu")
        with open(src, "w") as f:
            f.write(text)
        lib = os.path.join(OUT, name, "libssim_eval.so")
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                print(f"  {name}: {line.strip()}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        dll = ctypes.CDLL(lib)
        dll.ssim_eval.argtypes = ([ctypes.c_void_p] * 2 +
                                  [ctypes.POINTER(ctypes.c_longlong),
                                   ctypes.c_int] + [ctypes.c_void_p] * 2 +
                                  [ctypes.c_int] * 4 + [ctypes.c_float] * 2 +
                                  [ctypes.c_void_p])
        dll.ssim_eval.restype = ctypes.c_int
        dll.ssim_eval_tiles.argtypes = [ctypes.c_int, ctypes.c_int]
        dll.ssim_eval_tiles.restype = ctypes.c_int
        libs[name] = dll
    return libs


def launcher(dll, x, y, out):
    b, h, w, c = x.shape
    partials = torch.zeros(b * c * dll.ssim_eval_tiles(h, w),
                           dtype=torch.float32, device=x.device)
    strides = (ctypes.c_longlong * 4)(*x.stride())
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = dll.ssim_eval(x.data_ptr(), y.data_ptr(), strides, 0,
                            partials.data_ptr(), out.data_ptr(), b, h, w, c,
                            (0.01 * 255) ** 2, (0.03 * 255) ** 2, stream)
        if err:
            raise RuntimeError(f"ssim_eval launch failed: CUDA error {err}")
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "ssim_variants.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_ssim_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from ai_based_frame_interpolation_torch.ops.ssim import ssim_eval

    smi = smoke.card()
    libs = build()
    results = []
    for b, h, w in SHAPES:
        x, y = smoke.ssim_inputs(b, h, w, 1, seed=11)
        want = ssim_eval(x, y)
        out = torch.empty(b, dtype=torch.float32, device="cuda")
        flops, byts = smoke.ssim_flops_bytes(b, h, w, 1)
        bound_ms = smoke.bound(flops, byts, smoke.H100_F32_FLOPS)[0]
        order = list(VARIANTS) + list(reversed(VARIANTS))
        for name in order:
            run = launcher(libs[name], x, y, out)
            run()
            first = out.clone()
            run()
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            assert err <= smoke.SSIM_BOUND, f"{name} disagrees by {err}"
            assert torch.equal(first, out), f"{name} is not deterministic"
            ms = smoke.cuda_ms(run, 20)
            parts = {}
            dev = smoke.kernel_device_ms(run, ("ssim",), 20, parts)
            print(f"[{smi}] ssim_eval {name} {b}x{h}x{w} gray uint8: "
                  f"{ms:.4f} ms (events, raw launches), device "
                  f"{smoke._ms(dev)} (profiler; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in parts.items())
                  + f"), bound {bound_ms:.4f} ms, max|kernel-plain| "
                  f"{err:.3g}", flush=True)
            results.append({"variant": name, "shape": [b, h, w], "ms": ms,
                            "device_ms": dev, "parts": parts,
                            "bound_ms": bound_ms, "max_abs_err": err})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": results}, f, indent=1)
    print(json.dumps({"card": smi, "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
