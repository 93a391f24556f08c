// Fused flow sampler for Hopper (sm_90a).
//
// Replaces ops/pallas/warp_fused.py:sample_fused of the JAX package (its
// Pallas body _sampler_kernel): two backward warps with the "shifts"
// semantics of ops/warp.py and the Super-SloMo blend,
//
//   g0  = warp(f1, -t * F),  g1 = warp(f2, (1 - t) * F)
//   out = ((1-t) m g0 + t (1-m) g1) / ((1-t) m + t (1-m) + 1e-6)
//
// all in f32. Per warp and axis: d = clamp(s * f, -rmax, rmax) (the clamp
// before the grid is added), pos = clamp(float(p) + d, 0, n-1), k0 =
// floor(pos), frac = pos - k0, and the two taps k0 and min(k0+1, n-1). The
// X pass runs first: the Y pass interpolates between rows y0 and y1, each
// X-warped with the x displacement AT THAT SOURCE ROW. Products and sums
// use the _rn intrinsics so that nvcc does not contract them into FMAs:
// the kernel then rounds where the plain version (ops/warp_fused.py) does,
// and its outputs are bit-identical to it.
//
// What bounds it on the H100: at 1088x1920 gray it reads f1 and f2 (bf16,
// 2 + 2 bytes per pixel), the two flow planes and the mask (f32, 12) and
// writes out, g0 and g1 (f32, 12): 28 bytes per pixel, 58.5 MB per frame,
// 17.5 us at 3.35 TB/s, against about 60 FLOP per pixel. It is bound by
// memory traffic; after it, by the SM's issue of about 150 instructions a
// pixel (six clamped taps, six lerps, the blend) and by the latency of
// its three-deep chain of dependent loads (fy -> fx at two source rows ->
// four frame taps, per warp).
//
// What the design does about it (the tiled path):
// - The clamp bounds every tap: |d| <= R = max_flow, and the taps are k0
//   and k0 + 1. So a TH x TW output tile (32 x 64) reads only a window: fx
//   at rows [y0-R, y0+TH+R] and the tile's own columns; f1 and f2 at the
//   same rows and columns [x0-R, x0+TW+R]; fy and the mask at the tile.
//   The taps are gathered from that window through L1, directly: staging
//   each window in shared memory by cp.async a tile ahead was slower on
//   the H100 at 1 and 8 x 1088x1920 (PERF.md section 6; the staged build
//   is a patch in scripts/torch_sampler_variants.py): its copies,
//   barriers and lower occupancy cost more than the L1 misses they save.
// - Persistent blocks (512 threads, two an SM at 64 registers) walk a
//   list of tiles; fy and the mask of a block's next tile are loaded (as
//   16-byte vectors where the rows allow) before the current tile's
//   arithmetic, so their device-memory latency is hidden.
// - A thread takes four consecutive pixels of a row: four independent tap
//   chains, and 16-byte stores of out, g0 and g1 where the rows allow.
// - Every offset inside a plane is 32-bit, from a 64-bit base per batch
//   item and tile.
// - No conversion instructions in the tap math (they issue at 16 a clock
//   an SM): float(p) by an OR and a subtraction, floor(pos) and its int by
//   one add rounding down onto 2^23 (exact for 0 <= pos < 2^22, so H and
//   W are at most 2^22).
// The tiled path takes gray frames (bf16 or f32) whose inputs all have a
// column stride of 1 and planes of fewer than 2^31 elements: contiguous
// NHWC, and the NHWC views of NCHW planes the flow model passes
// (models/flow.py). Everything else (RGB, other views) takes the general
// path: one thread per pixel, taps read at any element strides, the
// port's first design. sample_fused_path reports which path a call takes.
//
// Layouts: every input is addressed by the element strides the caller
// passes (batch, row, column, channel). f1, f2 bf16 or f32 [B,H,W,C];
// flow f32 [B,H,W,2] (dx, dy); mask f32 [B,H,W,1]; t f32 [B]. out, g0 and
// g1 are written as contiguous f32 [B,H,W,C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_C = 3;
constexpr int BX = 64;                 // general path block: 64 columns x 4 rows
constexpr int BY = 4;

// the tap math's exact conversions hold for positions below 2^22
constexpr int MAX_HW = 1 << 22;
// tiled path: a thread takes PX consecutive pixels of a row, TW / PX
// threads a tile row
constexpr int PX = 4;
constexpr int TW = 64;
constexpr int TCOLS = TW / PX;
constexpr int THREADS = 512;
constexpr int TH = THREADS / TCOLS;

struct Strides {
  long long f1[4], f2[4], flow[4], mask[3];
};

__device__ __forceinline__ float load(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

// (1-w) a + w b, rounded as the plain version rounds it
__device__ __forceinline__ float lerp(float a, float b, float w) {
  return __fadd_rn(__fmul_rn(a, __fsub_rn(1.f, w)), __fmul_rn(b, w));
}

// an int in [0, 2^23) as f32, exactly
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.f);
}

// the clamped position along an axis (pf = float(p), nmax = float(n - 1)):
// tap k0, weight frac
__device__ __forceinline__ int tap(float pf, float s, float f, float rmax, float nmax,
                                   float* frac) {
  const float d = fminf(fmaxf(__fmul_rn(s, f), -rmax), rmax);
  const float pos = fminf(fmaxf(__fadd_rn(pf, d), 0.f), nmax);
  const float k = __fadd_rd(pos, 8388608.f);       // 2^23 + floor(pos)
  *frac = __fsub_rn(pos, __fsub_rn(k, 8388608.f));
  return __float_as_int(k) - 0x4B000000;
}

__device__ __forceinline__ float blend(float a, float c1, float w0, float w1, float den) {
  return __fdiv_rn(__fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, c1)), den);
}

// ---------------------------------------------------------------- general path

// one shifts warp of img at output pixel (y, x) with scale s: X pass at
// the two source rows, then the Y lerp
template <typename T>
__device__ __forceinline__ void warp_pixel(const T* img, const long long* is,
                                           const float* fx, const long long* fs,
                                           int y, int x, float fy, float s,
                                           float rmax, int H, int W, int C,
                                           float (&res)[MAX_C]) {
  float wy;
  const int y0 = tap(exact_float(y), s, fy, rmax, exact_float(H - 1), &wy);
  const int y1 = min(y0 + 1, H - 1);
  float rows[2][MAX_C];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = k ? y1 : y0;
    float wx;
    const int x0 = tap(exact_float(x), s, __ldg(fx + r * fs[1] + x * fs[2]), rmax,
                       exact_float(W - 1), &wx);
    const int x1 = min(x0 + 1, W - 1);
    const T* row = img + r * is[1];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) {
        rows[k][c] = lerp(load(row + x0 * is[2] + c * is[3]),
                          load(row + x1 * is[2] + c * is[3]), wx);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) res[c] = lerp(rows[0][c], rows[1][c], wy);
  }
}

template <typename T>
__global__ void __launch_bounds__(BX * BY)
sample_fused_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                    const float* __restrict__ flow, const float* __restrict__ mask,
                    const float* __restrict__ tv, Strides s,
                    float* __restrict__ out, float* __restrict__ g0,
                    float* __restrict__ g1, int H, int W, int C, float rmax) {
  const int x = blockIdx.x * BX + threadIdx.x;
  const int y = blockIdx.y * BY + threadIdx.y;
  const int b = blockIdx.z;
  if (x >= W || y >= H) return;
  const float t = __ldg(tv + b);
  const float* fx = flow + b * s.flow[0];
  const float fy = __ldg(fx + y * s.flow[1] + x * s.flow[2] + s.flow[3]);
  const float m = __ldg(mask + b * s.mask[0] + y * s.mask[1] + x * s.mask[2]);
  float a[MAX_C], c1[MAX_C];
  warp_pixel(f1 + b * s.f1[0], s.f1, fx, s.flow, y, x, fy, -t, rmax, H, W, C, a);
  warp_pixel(f2 + b * s.f2[0], s.f2, fx, s.flow, y, x, fy, __fsub_rn(1.f, t),
             rmax, H, W, C, c1);
  const float w0 = __fmul_rn(__fsub_rn(1.f, t), m);
  const float w1 = __fmul_rn(t, __fsub_rn(1.f, m));
  const float den = __fadd_rn(__fadd_rn(w0, w1), 1e-6f);
  const long long o = ((static_cast<long long>(b) * H + y) * W + x) * C;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < C) {
      g0[o + c] = a[c];
      g1[o + c] = c1[c];
      out[o + c] = blend(a[c], c1[c], w0, w1, den);
    }
  }
}

// ------------------------------------------------------------------ tiled path

// One array of a tile's batch item: element (row r, column c) is at
// base + (r * sh + c) * e bytes, a 32-bit offset inside the plane.
struct Rows {
  const unsigned char* base;
  int sh;
};

struct Tile {
  int b, y0, x0;
  Rows fx, f1, f2;
};

__device__ __forceinline__ Rows rows_of(const void* base, long long sb, long long sh, int b,
                                        int e) {
  Rows a;
  a.base = static_cast<const unsigned char*>(base) + b * sb * e;
  a.sh = static_cast<int>(sh);
  return a;
}

struct Args {
  const void* f1;
  const void* f2;
  const float* flow;
  const float* mask;
  const float* tv;
  Strides s;
  float* out;
  float* g0;
  float* g1;
  int B, H, W, tiles_x, tiles_y, tiles;
  int vec_out;   // out, g0, g1 take 16-byte stores (W % 4 == 0, aligned)
  int vec_in;    // fy and the mask take 16-byte loads
  float rmax;
};

template <typename T>
__device__ __forceinline__ Tile tile_at(const Args& A, int tile) {
  Tile p;
  const int per_b = A.tiles_x * A.tiles_y;
  p.b = tile / per_b;
  const int rem = tile - p.b * per_b;
  const int ty = rem / A.tiles_x;
  p.y0 = ty * TH;
  p.x0 = (rem - ty * A.tiles_x) * TW;
  const int e = static_cast<int>(sizeof(T));
  p.fx = rows_of(A.flow, A.s.flow[0], A.s.flow[1], p.b, 4);
  p.f1 = rows_of(A.f1, A.s.f1[0], A.s.f1[1], p.b, e);
  p.f2 = rows_of(A.f2, A.s.f2[0], A.s.f2[1], p.b, e);
  return p;
}

// the value at image (row r, column c) of an array
template <typename T>
__device__ __forceinline__ float at(const Rows& a, int r, int c) {
  return load(reinterpret_cast<const T*>(a.base) + (r * a.sh + c));
}

// one shifts warp of a tile's image at output pixel (y, x) with scale s:
// X pass at the two source rows, then the Y lerp
template <typename T>
__device__ __forceinline__ float warp_tile(const Rows& fx, const Rows& img, float yf, int x,
                                           float xf, float fyv, float s, float rmax,
                                           float hmax, float wmax, int H, int W) {
  float wy;
  const int ya = tap(yf, s, fyv, rmax, hmax, &wy);
  const int yb = min(ya + 1, H - 1);
  float rows[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = k ? yb : ya;
    float wx;
    const int xa = tap(xf, s, at<float>(fx, r, x), rmax, wmax, &wx);
    const int xb = min(xa + 1, W - 1);
    rows[k] = lerp(at<T>(img, r, xa), at<T>(img, r, xb), wx);
  }
  return lerp(rows[0], rows[1], wy);
}

// fy and the mask at a thread's four pixels of tile p (lanes past the
// right edge repeat the last pixel)
__device__ __forceinline__ void load_fym(const Args& A, int b, int y, int xs, float (&fyv)[PX],
                                         float (&mv)[PX]) {
  const float* fyr = A.flow + b * A.s.flow[0] + y * A.s.flow[1] + A.s.flow[3];
  const float* mr = A.mask + b * A.s.mask[0] + y * A.s.mask[1];
  if (A.vec_in) {
#pragma unroll
    for (int j = 0; j < PX; j += 4) {
      const float4 f4 = __ldg(reinterpret_cast<const float4*>(fyr + xs + j));
      const float4 m4 = __ldg(reinterpret_cast<const float4*>(mr + xs + j));
      fyv[j] = f4.x, fyv[j + 1] = f4.y, fyv[j + 2] = f4.z, fyv[j + 3] = f4.w;
      mv[j] = m4.x, mv[j + 1] = m4.y, mv[j + 2] = m4.z, mv[j + 3] = m4.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      const int x = min(xs + j, A.W - 1);
      fyv[j] = __ldg(fyr + x);
      mv[j] = __ldg(mr + x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
sample_tiled_kernel(const Args A) {
  const int H = A.H, W = A.W;
  const float rmax = A.rmax;
  const float hmax = exact_float(H - 1), wmax = exact_float(W - 1);
  const int trow = threadIdx.x / TCOLS;
  const int tcol = threadIdx.x % TCOLS;
  int tile = blockIdx.x;
  // fy and the mask of the block's tiles, a tile ahead
  float fyv[PX], mv[PX];
  if (tile < A.tiles) {
    const Tile p = tile_at<T>(A, tile);
    if (p.y0 + trow < H && p.x0 + tcol * PX < W) {
      load_fym(A, p.b, p.y0 + trow, p.x0 + tcol * PX, fyv, mv);
    }
  }
  for (; tile < A.tiles; tile += gridDim.x) {
    const Tile p = tile_at<T>(A, tile);
    const int y = p.y0 + trow;
    const int xs = p.x0 + tcol * PX;
    const int next = tile + gridDim.x;
    float nfy[PX], nm[PX];
    if (next < A.tiles) {
      const Tile q = tile_at<T>(A, next);
      if (q.y0 + trow < H && q.x0 + tcol * PX < W) {
        load_fym(A, q.b, q.y0 + trow, q.x0 + tcol * PX, nfy, nm);
      }
    }
    if (y < H && xs < W) {
      const float t = __ldg(A.tv + p.b);
      const float s0 = -t, s1 = __fsub_rn(1.f, t);
      const float yf = exact_float(y);
      float o[PX], a[PX], c[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int x = min(xs + j, W - 1);
        const float xf = exact_float(x);
        a[j] = warp_tile<T>(p.fx, p.f1, yf, x, xf, fyv[j], s0, rmax, hmax, wmax, H, W);
        c[j] = warp_tile<T>(p.fx, p.f2, yf, x, xf, fyv[j], s1, rmax, hmax, wmax, H, W);
        const float w0 = __fmul_rn(s1, mv[j]);
        const float w1 = __fmul_rn(t, __fsub_rn(1.f, mv[j]));
        const float den = __fadd_rn(__fadd_rn(w0, w1), 1e-6f);
        o[j] = blend(a[j], c[j], w0, w1, den);
      }
      const long long off = (static_cast<long long>(p.b) * H + y) * W + xs;
      if (A.vec_out) {
#pragma unroll
        for (int j = 0; j < PX; j += 4) {
          *reinterpret_cast<float4*>(A.out + off + j) =
              make_float4(o[j], o[j + 1], o[j + 2], o[j + 3]);
          *reinterpret_cast<float4*>(A.g0 + off + j) =
              make_float4(a[j], a[j + 1], a[j + 2], a[j + 3]);
          *reinterpret_cast<float4*>(A.g1 + off + j) =
              make_float4(c[j], c[j + 1], c[j + 2], c[j + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          if (xs + j < W) {
            A.out[off + j] = o[j];
            A.g0[off + j] = a[j];
            A.g1[off + j] = c[j];
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      fyv[j] = nfy[j];
      mv[j] = nm[j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// blocks the grid holds on a device (SMs x resident blocks), found once
// per device and instance: the occupancy query costs more host time than
// a small launch's whole kernel
constexpr int MAX_DEVICES = 64;

template <typename T>
int launch_tiled(const Args& A, cudaStream_t st) {
  static int resident[MAX_DEVICES];    // 0: not yet known
  int device = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  if (resident[device] == 0) {
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess) {
      return static_cast<int>(err);
    }
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, sample_tiled_kernel<T>, THREADS, 0)) != cudaSuccess) {
      return static_cast<int>(err);
    }
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident[device] = sms * per_sm;
  }
  const int blocks = min(A.tiles, resident[device]);
  sample_tiled_kernel<T><<<blocks, THREADS, 0, st>>>(A);
  return static_cast<int>(cudaGetLastError());
}

Strides strides_of(const long long* strides) {
  Strides s;
  for (int i = 0; i < 4; ++i) {
    s.f1[i] = strides[i];
    s.f2[i] = strides[4 + i];
    s.flow[i] = strides[8 + i];
  }
  for (int i = 0; i < 3; ++i) s.mask[i] = strides[12 + i];
  return s;
}

// the tiled path: gray, every input at column stride 1, 32-bit offsets
// inside a plane
bool tiled_route(const Strides& s, int H, int W, int C) {
  const auto extent = [&](const long long* st, long long extra) {
    return (H - 1) * st[1] + (W - 1) + extra;
  };
  return C == 1 && s.f1[2] == 1 && s.f2[2] == 1 && s.flow[2] == 1 && s.mask[2] == 1 &&
         extent(s.f1, 0) < 0x7fffffffLL && extent(s.f2, 0) < 0x7fffffffLL &&
         extent(s.flow, s.flow[3]) < 0x7fffffffLL && extent(s.mask, 0) < 0x7fffffffLL;
}

}  // namespace

// 1 if sample_fused takes the tiled path for these strides (as sample_fused
// takes them) and sizes, 0 if the general path.
extern "C" int sample_fused_path(const long long* strides, int H, int W, int C) {
  return tiled_route(strides_of(strides), H, W, C) ? 1 : 0;
}

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// strides: 15 element strides, f1 (b, y, x, c), f2 (b, y, x, c), flow
// (b, y, x, c), mask (b, y, x).
extern "C" int sample_fused(const void* f1, const void* f2, const void* flow,
                            const void* mask, const void* t,
                            const long long* strides, void* out, void* g0,
                            void* g1, int B, int H, int W, int C, int max_flow,
                            int img_f32, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || H > MAX_HW || W > MAX_HW || C < 1 ||
      C > MAX_C || max_flow < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Strides s = strides_of(strides);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tiled_route(s, H, W, C)) {
    Args A;
    A.f1 = f1;
    A.f2 = f2;
    A.flow = static_cast<const float*>(flow);
    A.mask = static_cast<const float*>(mask);
    A.tv = static_cast<const float*>(t);
    A.s = s;
    A.out = static_cast<float*>(out);
    A.g0 = static_cast<float*>(g0);
    A.g1 = static_cast<float*>(g1);
    A.B = B;
    A.H = H;
    A.W = W;
    A.tiles_x = (W + TW - 1) / TW;
    A.tiles_y = (H + TH - 1) / TH;
    const long long tiles = static_cast<long long>(B) * A.tiles_x * A.tiles_y;
    if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    A.tiles = static_cast<int>(tiles);
    A.vec_out = W % PX == 0 && aligned16(out) && aligned16(g0) && aligned16(g1);
    A.vec_in = W % PX == 0 && aligned16(static_cast<const float*>(flow) + s.flow[3]) &&
               aligned16(mask) && s.flow[0] % 4 == 0 && s.mask[0] % 4 == 0 &&
               s.flow[1] % 4 == 0 && s.mask[1] % 4 == 0;
    A.rmax = static_cast<float>(max_flow);
    return img_f32 ? launch_tiled<float>(A, st) : launch_tiled<__nv_bfloat16>(A, st);
  }
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const float rmax = static_cast<float>(max_flow);
  if (img_f32) {
    sample_fused_kernel<float><<<grid, block, 0, st>>>(
        static_cast<const float*>(f1), static_cast<const float*>(f2),
        static_cast<const float*>(flow), static_cast<const float*>(mask),
        static_cast<const float*>(t), s, static_cast<float*>(out),
        static_cast<float*>(g0), static_cast<float*>(g1), H, W, C, rmax);
  } else {
    sample_fused_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        static_cast<const __nv_bfloat16*>(f1), static_cast<const __nv_bfloat16*>(f2),
        static_cast<const float*>(flow), static_cast<const float*>(mask),
        static_cast<const float*>(t), s, static_cast<float*>(out),
        static_cast<float*>(g0), static_cast<float*>(g1), H, W, C, rmax);
  }
  return static_cast<int>(cudaGetLastError());
}
