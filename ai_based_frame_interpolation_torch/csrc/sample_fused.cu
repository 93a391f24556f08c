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
// the kernel then rounds where the plain version (ops/warp_fused.py) does.
//
// What bounds it on the H100: at 1088x1920 gray it reads f1 and f2 (bf16,
// 2 + 2 bytes per pixel), the two flow planes and the mask (f32, 12) and
// writes out, g0 and g1 (f32, 12): 28 bytes per pixel, 58.5 MB per frame,
// 17.5 us at 3.35 TB/s, against about 60 FLOP per pixel. It is bound by
// memory traffic.
//
// What the design does about it: one thread per output pixel computes the
// taps directly, reading each input once from device memory (the taps of
// neighbouring threads fall on the same or adjacent rows, so the gathers
// hit L1/L2), and writes each output once; nothing is staged. The Pallas
// kernel's halo-row DMA, its 2*(2*rmax+2) static lane slices and its VMEM
// cap are TPU workarounds with no counterpart here, and there is no bound
// on the width. For RGB the taps are computed once and applied to every
// channel.
//
// Layouts: every input is addressed by the element strides the caller
// passes (batch, row, column, channel), so NHWC tensors and NHWC views of
// NCHW tensors both go in without a copy. f1, f2 bf16 or f32 [B,H,W,C];
// flow f32 [B,H,W,2] (dx, dy); mask f32 [B,H,W,1]; t f32 [B]. out, g0 and
// g1 are written as contiguous f32 [B,H,W,C].

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 3;
constexpr int BX = 64;                 // block: 64 columns x 4 rows
constexpr int BY = 4;

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

// the clamped position along an axis of n pixels: tap k0, weight frac
__device__ __forceinline__ int tap(int p, float s, float f, float rmax, int n,
                                   float* frac) {
  const float d = fminf(fmaxf(__fmul_rn(s, f), -rmax), rmax);
  const float pos = fminf(fmaxf(__fadd_rn(static_cast<float>(p), d), 0.f),
                          static_cast<float>(n - 1));
  const float k0 = floorf(pos);
  *frac = __fsub_rn(pos, k0);
  return static_cast<int>(k0);
}

// one shifts warp of img at output pixel (y, x) with scale s: X pass at
// the two source rows, then the Y lerp
template <typename T>
__device__ __forceinline__ void warp_pixel(const T* img, const long long* is,
                                           const float* fx, const long long* fs,
                                           int y, int x, float fy, float s,
                                           float rmax, int H, int W, int C,
                                           float (&res)[MAX_C]) {
  float wy;
  const int y0 = tap(y, s, fy, rmax, H, &wy);
  const int y1 = min(y0 + 1, H - 1);
  float rows[2][MAX_C];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int r = k ? y1 : y0;
    float wx;
    const int x0 = tap(x, s, __ldg(fx + r * fs[1] + x * fs[2]), rmax, W, &wx);
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
      out[o + c] = __fdiv_rn(__fadd_rn(__fmul_rn(w0, a[c]), __fmul_rn(w1, c1[c])), den);
    }
  }
}

}  // namespace

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// strides: 15 element strides, f1 (b, y, x, c), f2 (b, y, x, c), flow
// (b, y, x, c), mask (b, y, x).
extern "C" int sample_fused(const void* f1, const void* f2, const void* flow,
                            const void* mask, const void* t,
                            const long long* strides, void* out, void* g0,
                            void* g1, int B, int H, int W, int C, int max_flow,
                            int img_f32, void* stream) {
  if (B < 1 || B > 65535 || H < 2 || W < 2 || C < 1 || C > MAX_C || max_flow < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Strides s;
  for (int i = 0; i < 4; ++i) {
    s.f1[i] = strides[i];
    s.f2[i] = strides[4 + i];
    s.flow[i] = strides[8 + i];
  }
  for (int i = 0; i < 3; ++i) s.mask[i] = strides[12 + i];
  const dim3 block(BX, BY);
  const dim3 grid((W + BX - 1) / BX, (H + BY - 1) / BY, B);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
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
