"""The flow sampler's tiled design against its alternatives, in one run.

    python3 scripts/torch_sampler_variants.py [--out FILE]

Builds ``csrc/sample_fused.cu`` into ``build/sampler_variants/``
(ignored by git) as the port builds it (``tiled``: persistent 32x64
tiles, four pixels a thread, taps gathered through L1, two 512-thread
blocks an SM), and a copy edited by the text replacements in ``STAGED``
(``staged``: the same loop with each tile's window staged in shared
memory by cp.async a tile ahead: fx at rows [y0-R, y0+TH+R] and the
tile's columns, f1 and f2 at those rows and columns [x0-R, x0+TW+R], in
two stages; rows copied 16 bytes at a time where aligned). Each edit
must match the source, or the script stops before it builds anything.
Then, at 1 and 8 x 1088x1920 gray
bf16, max_flow 16 (``chip_smoke.sampler_inputs``: random flows to 1.5x
max_flow, the flow model's NCHW views; at b8 also a smooth field, 10 px
sinusoids, as a motion pass gives), it calls each library's C function on
the same inputs with outputs allocated once, and the general path (one
thread a pixel, the first port's design) by passing the flow as a
contiguous NHWC copy (column stride 2). Each variant must be
bit-identical to the plain version; each is timed by CUDA events over 20
launches and by torch.profiler (the kernel's device time), in the order
tiled, staged, general, general, staged, tiled. Prints one line per timing
and a JSON line, and writes it to ``--out``. Needs the card and nvcc.
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
OUT = os.path.join(ROOT, "build", "sampler_variants")
SRC = "ai_based_frame_interpolation_torch/csrc/sample_fused.cu"
# the staged build: [(text in the source, its replacement)]
STAGED = [
    # cp.async, the stage's layout, and arrays addressed in the stage
    ("""// One array of a tile's batch item: element (row r, column c) is at
// base + (r * sh + c) * e bytes, a 32-bit offset inside the plane.
struct Rows {
  const unsigned char* base;
  int sh;
};
""", """constexpr int SMEM_MAX = 232448;       // 227 KB a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, long long src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, long long src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\\n" ::: "memory");
}

// The shared-memory layout of one stage (bytes; every row a multiple of
// 16): NR = TH + 2R + 1 rows each of fx, f1 and f2.
struct Geo {
  int R, NR;
  int cap_fx;    // bytes a row of fx: TW f32 + 15 for the address modulo 16
  int cap_f;     // bytes a row of f1, f2: (TW + 2R + 1) elements + 15
  int off_f1, off_f2, stage;
};

// One array of a tile, staged: slot i is image row r_nom + i, column c at
// byte (c - c_nom) * e from the nominal element (r_nom, c_nom) at address
// g0 (which may lie before the array: only the part of a row inside the
// image is read); its rows are rs bytes apart, a multiple of 16, so every
// staged row keeps the same address modulo 16 and element (r, c) is at
// byte at0 + r * cap + c * e of the stage.
struct Rows {
  long long g0, rs;
  int off, cap, r_nom, c_nom, n, at0;
};
"""),
    ("""__device__ __forceinline__ Rows rows_of(const void* base, long long sb, long long sh, int b,
                                        int e) {
  Rows a;
  a.base = static_cast<const unsigned char*>(base) + b * sb * e;
  a.sh = static_cast<int>(sh);
  return a;
}
""", """__device__ __forceinline__ Rows rows_of(const void* base, long long sb, long long sh, int b,
                                        int e, int off, int cap, int r_nom, int c_nom, int n) {
  Rows a;
  a.rs = sh * e;
  a.g0 = reinterpret_cast<long long>(base) +
         (b * sb + static_cast<long long>(r_nom) * sh + c_nom) * e;
  a.off = off;
  a.cap = cap;
  a.r_nom = r_nom;
  a.c_nom = c_nom;
  a.n = n;
  a.at0 = off + static_cast<int>(a.g0 & 15) - r_nom * cap - c_nom * e;
  return a;
}
"""),
    ("  float rmax;\n};\n", "  float rmax;\n  Geo geo;\n};\n"),
    ("""  const int e = static_cast<int>(sizeof(T));
  p.fx = rows_of(A.flow, A.s.flow[0], A.s.flow[1], p.b, 4);
  p.f1 = rows_of(A.f1, A.s.f1[0], A.s.f1[1], p.b, e);
  p.f2 = rows_of(A.f2, A.s.f2[0], A.s.f2[1], p.b, e);
""", """  const Geo& G = A.geo;
  const int R = G.R, e = static_cast<int>(sizeof(T));
  p.fx = rows_of(A.flow, A.s.flow[0], A.s.flow[1], p.b, 4, 0, G.cap_fx, p.y0 - R, p.x0, TW);
  p.f1 = rows_of(A.f1, A.s.f1[0], A.s.f1[1], p.b, e, G.off_f1, G.cap_f, p.y0 - R, p.x0 - R,
                 TW + 2 * R + 1);
  p.f2 = rows_of(A.f2, A.s.f2[0], A.s.f2[1], p.b, e, G.off_f2, G.cap_f, p.y0 - R, p.x0 - R,
                 TW + 2 * R + 1);
"""),
    # taps read from the stage; the copies that fill it
    ("""__device__ __forceinline__ float at(const Rows& a, int r, int c) {
  return load(reinterpret_cast<const T*>(a.base) + (r * a.sh + c));
}
""", """__device__ __forceinline__ float at(const unsigned char* stage, const Rows& a, int r, int c) {
  const unsigned char* p = stage + (a.at0 + r * a.cap + c * static_cast<int>(sizeof(T)));
  if constexpr (sizeof(T) == 4) {
    return *reinterpret_cast<const float*>(p);
  } else {
    return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
  }
}

// Global bytes [s, end) to d + (s - a0): 4-byte copies where aligned,
// 2-byte loads for a bf16 piece that is not.
__device__ __forceinline__ void stage_piece(unsigned char* d, long long a0, long long s,
                                            long long end) {
  while (s < end) {
    if ((s & 3) == 0 && end - s >= 4) {
      cp_async4(d + (s - a0), s);
      s += 4;
    } else {
      *reinterpret_cast<uint16_t*>(d + (s - a0)) =
          *reinterpret_cast<const uint16_t*>(static_cast<uintptr_t>(s));
      s += 2;
    }
  }
}

// Issue the copies of slot i of array a into the stage: lane j takes the
// row's 16-byte chunks j, j + 32, ...
__device__ __forceinline__ void stage_row(unsigned char* stage, const Rows& a, int i, int e,
                                          int lane, int H, int W) {
  const int r = a.r_nom + i;
  if (r < 0 || r >= H) return;
  const long long gi = a.g0 + i * a.rs;
  const long long lo = gi + static_cast<long long>(max(a.c_nom, 0) - a.c_nom) * e;
  const long long hi = gi + static_cast<long long>(min(a.c_nom + a.n, W) - a.c_nom) * e;
  const long long a0 = gi & ~15LL;
  unsigned char* d = stage + a.off + i * a.cap;
  for (int j = lane; j * 16 < a.cap; j += 32) {
    const long long cs = a0 + 16LL * j;
    const long long s = max(lo, cs), end = min(hi, cs + 16);
    if (s >= end) continue;
    if (s == cs && end == cs + 16) {
      cp_async16(d + 16 * j, cs);
    } else {
      stage_piece(d, a0, s, end);
    }
  }
}

// a tile's window: the warps take rows of fx, f1 and f2 in turn
template <typename T>
__device__ __forceinline__ void stage_tile(unsigned char* stage, const Tile& p, int nr, int H,
                                           int W) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int e = static_cast<int>(sizeof(T));
  for (int q = warp; q < 3 * nr; q += THREADS / 32) {
    if (q < nr) {
      stage_row(stage, p.fx, q, 4, lane, H, W);
    } else if (q < 2 * nr) {
      stage_row(stage, p.f1, q - nr, e, lane, H, W);
    } else {
      stage_row(stage, p.f2, q - 2 * nr, e, lane, H, W);
    }
  }
}
"""),
    ("__device__ __forceinline__ float warp_tile(const Rows& fx,",
     "__device__ __forceinline__ float warp_tile(const unsigned char* stage, const Rows& fx,"),
    ("at<float>(fx, r, x)", "at<float>(stage, fx, r, x)"),
    ("lerp(at<T>(img, r, xa), at<T>(img, r, xb), wx)",
     "lerp(at<T>(stage, img, r, xa), at<T>(stage, img, r, xb), wx)"),
    # the kernel: the first tile staged before the loop, the next one
    # during each tile's arithmetic, two stages in turn
    ("""sample_tiled_kernel(const Args A) {
  const int H = A.H, W = A.W;
""", """sample_tiled_kernel(const Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = A.H, W = A.W, nr = A.geo.NR;
"""),
    ("""  int tile = blockIdx.x;
""", """  int tile = blockIdx.x;
  if (tile < A.tiles) stage_tile<T>(smem, tile_at<T>(A, tile), nr, H, W);
  cp_async_commit();
"""),
    ("""  for (; tile < A.tiles; tile += gridDim.x) {
""", """  for (int k = 0; tile < A.tiles; tile += gridDim.x, ++k) {
    const unsigned char* stage = smem + (k & 1) * A.geo.stage;
"""),
    ("""    if (y < H && xs < W) {
      const float t = __ldg(A.tv + p.b);""", """    if (next < A.tiles) {
      stage_tile<T>(smem + ((k + 1) & 1) * A.geo.stage, tile_at<T>(A, next), nr, H, W);
    }
    cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    if (y < H && xs < W) {
      const float t = __ldg(A.tv + p.b);"""),
    ("warp_tile<T>(p.fx, p.f1,", "warp_tile<T>(stage, p.fx, p.f1,"),
    ("warp_tile<T>(p.fx, p.f2,", "warp_tile<T>(stage, p.fx, p.f2,"),
    ("""      mv[j] = nm[j];
    }
  }
}
""", """      mv[j] = nm[j];
    }
    __syncthreads();   // before the next iteration refills this stage
  }
}

Geo geometry(int R, int elem) {
  Geo g;
  const auto up16 = [](int v) { return (v + 15) / 16 * 16; };
  g.R = R;
  g.NR = TH + 2 * R + 1;
  g.cap_fx = up16(TW * 4 + 15);
  g.cap_f = up16((TW + 2 * R + 1) * elem + 15);
  g.off_f1 = g.NR * g.cap_fx;
  g.off_f2 = g.off_f1 + g.NR * g.cap_f;
  g.stage = g.off_f2 + g.NR * g.cap_f;
  return g;
}
"""),
    # the launch: two stages of dynamic shared memory, the occupancy
    # queried at every call (the stage depends on R)
    ("""  static int resident[MAX_DEVICES];    // 0: not yet known
""", """  static int resident[MAX_DEVICES];
  const int smem = 2 * A.geo.stage;
"""),
    ("  if (resident[device] == 0) {\n", "  {\n"),
    ("""    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sample_tiled_kernel<T>, THREADS, 0)) != cudaSuccess) {""",
     """    if ((err = cudaFuncSetAttribute(sample_tiled_kernel<T>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess) {
      return static_cast<int>(err);
    }
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sample_tiled_kernel<T>, THREADS, smem)) != cudaSuccess) {"""),
    ("sample_tiled_kernel<T><<<blocks, THREADS, 0, st>>>(A);",
     "sample_tiled_kernel<T><<<blocks, THREADS, smem, st>>>(A);"),
    # the host: staged, also rows a multiple of 16 bytes apart and two
    # stages in shared memory
    ("""  if (tiled_route(s, H, W, C)) {
""", """  const int elem = img_f32 ? 4 : 2;
  const Geo geo = geometry(max_flow <= 4096 ? max_flow : 0, elem);
  if (tiled_route(s, H, W, C) && max_flow <= 4096 && 2 * geo.stage <= SMEM_MAX &&
      (s.f1[1] * elem) % 16 == 0 && (s.f2[1] * elem) % 16 == 0 &&
      (s.flow[1] * 4) % 16 == 0) {
"""),
    ("""    A.rmax = static_cast<float>(max_flow);
""", """    A.rmax = static_cast<float>(max_flow);
    A.geo = geo;
"""),
]
BUILDS = ("tiled", "staged")
ORDER = ("tiled", "staged", "general", "general", "staged", "tiled")


def build() -> dict:
    from ai_based_frame_interpolation_torch.ops import _build

    with open(os.path.join(ROOT, SRC)) as f:
        text = f.read()
    sources = {"tiled": text}
    for old, new in STAGED:
        if text.count(old) != 1:
            raise SystemExit(f"staged: {old.strip()[:60]!r} is not once in {SRC}")
        text = text.replace(old, new)
    sources["staged"] = text
    procs = {}
    for name in BUILDS:
        os.makedirs(os.path.join(OUT, name), exist_ok=True)
        src = os.path.join(OUT, name, "sample_fused.cu")
        with open(src, "w") as f:
            f.write(sources[name])
        lib = os.path.join(OUT, name, "libsample_fused.so")
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
        fn = ctypes.CDLL(lib).sample_fused
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def launcher(fn, args, outs, max_flow):
    f1, f2, flow, mask, t = args
    strides = (ctypes.c_longlong * 15)(*f1.stride(), *f2.stride(),
                                       *flow.stride(), *mask.stride()[:3])
    b, h, w, c = f1.shape
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = fn(f1.data_ptr(), f2.data_ptr(), flow.data_ptr(),
                 mask.data_ptr(), t.data_ptr(), strides,
                 *(o.data_ptr() for o in outs), b, h, w, c, max_flow, 0,
                 stream)
        if err:
            raise RuntimeError(f"sample_fused launch failed: CUDA error {err}")
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                 "sampler_variants.json"))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_sampler_variants: needs a CUDA card", file=sys.stderr)
        return 2
    import chip_smoke as smoke
    from ai_based_frame_interpolation_torch.ops.warp_fused import (
        sample_fused_reference)

    smi = smoke.card()
    libs = build()
    results = []
    for b, flows in ((1, "random"), (8, "random"), (8, "smooth")):
        mf = 16
        inputs = smoke.sampler_inputs(b, 1088, 1920, 1, mf,
                                      smoke.SAMPLER_TS8[:b])
        if flows == "smooth":
            yy = torch.arange(1088, device="cuda").view(1, 1088, 1) / 37.0
            xx = torch.arange(1920, device="cuda").view(1, 1, 1920) / 53.0
            field = inputs[2].permute(0, 3, 1, 2)     # the NCHW memory
            field[:, 0] = 10 * torch.sin(yy + xx)
            field[:, 1] = 10 * torch.cos(xx - yy)
        want = sample_fused_reference(*inputs, max_flow=mf)
        outs = [torch.empty_like(x) for x in want]
        nhwc_flow = inputs[2].contiguous()
        runs = {name: launcher(fn, inputs, outs, mf)
                for name, fn in libs.items()}
        runs["general"] = launcher(libs["tiled"], inputs[:2] + (nhwc_flow,)
                                   + inputs[3:], outs, mf)
        flops, byts = smoke.sampler_flops_bytes(b, 1088, 1920, 1)
        bound_ms = smoke.bound(flops, byts, smoke.H100_F32_FLOPS)[0]
        for name in ORDER:
            run = runs[name]
            for o in outs:
                o.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            exact = all(torch.equal(o, x) for o, x in zip(outs, want))
            assert exact, f"{name} is not bit-identical to the plain version"
            ms = smoke.cuda_ms(run, 20)
            dev = smoke.kernel_device_ms(run, ("sample",), 20)
            print(f"[{smi}] sample_fused {name} {b}x1088x1920 gray bf16 "
                  f"mf{mf} {flows} flows: {ms:.4f} ms (events, raw "
                  f"launches), device {smoke._ms(dev)} (profiler), bound "
                  f"{bound_ms:.4f} ms, bit-identical", flush=True)
            results.append({"variant": name, "batch": b, "flows": flows,
                            "ms": ms, "device_ms": dev, "bound_ms": bound_ms})
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"card": smi, "runs": results}, f, indent=1)
    print(json.dumps({"card": smi, "runs": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
