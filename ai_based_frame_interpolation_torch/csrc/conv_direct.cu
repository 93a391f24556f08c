// Direct convolutions on the CUDA cores for what the fused tensor-core
// kernels do not take: f32 compute at any width, and bf16 heads wider than
// 64 (sm_90a).
//
// Stands in for, at those configurations, the JAX package's
//   ops/pallas/refine_fused.py:refine_head_fused (rows 1 and 1b of PERF.md:
//     the dense and the depthwise refinement head),
//   ops/pallas/dconv_fused.py:double_conv_fused and up_double_conv_fused
//     (rows 5 and 6: the option core's double conv and up block),
// each composed from launches of the two kernels here (ops/conv_direct.py,
// ops/refine.py, ops/dconv_fused.py), with the intermediates in device
// memory:
//
//   conv_kernel:     out = act(T(T(conv(in, w)) + b))     KS x KS, SAME padding
//       in = x, or concat(x, up2(low)) on the channel axis (the up block);
//       or a depthwise 3x3 (one filter per channel); act = ReLU or none
//   head_out_kernel: out = T(pred + (conv1x1_f32(z, w3) + b3))
//
// T is float or __nv_bfloat16. Sums are f32 FMAs; the rounding points are
// the plain versions': for bf16 the conv sum rounds, the bias adds, the sum
// rounds again, then the ReLU; for f32 there are none. up2 is the half-pixel
// 2x bilinear upsample with the TPU kernel's rounding points (W pass, round
// to T, H pass, round), as csrc/double_conv.cu builds it; the depthwise sum
// runs in the TPU kernel's order (per kx the three ky terms, then the three
// kx partial sums), as csrc/refine_head.cu's depthwise instance.
//
// What bounds it on the H100: f32 FMAs at 67 TFLOP/s. The f32 w64 head at
// 1088x1920 does 77,312 FLOP per pixel, 161.5 GFLOP per frame, 2.4 ms at
// that peak, and each of its two 64-channel f32 intermediates is 535 MB per
// frame (0.16 ms at 3.35 TB/s each way). A fused f32 design (the
// intermediates on chip, or TF32 tensor cores where the result allows) is a
// later PR's work; this one is right and simple first.
//
// What the design does: a block computes a 16x16 pixel tile for 16 output
// channels (grid: tiles x batch x channel groups); 128 threads, each two
// pixels (rows ty and ty + 8) x 16 channels in registers. The input window
// (tile plus halo) and the weights pass through shared memory 16 input
// channels at a time (20 KB + 9 KB), so no width is too large for a tile:
// the limits are the grid's, B <= 65535 and out channels <= 65535 x 16.
// The window holds each channel as a plane (conflict-free reads along a
// row of pixels); a 16-channel weight row is four float4 broadcast reads.
//
// Layouts, channels-last and contiguous: x [B,H,W,c0] T, low [B,H/2,W/2,c1]
// T, out [B,H,W,cout] T; dense weights [KS*KS][c0+c1][cout] f32 (tap, in,
// out), depthwise [9][cout] f32, bias [cout] f32, the values rounded to T
// when packed (ops/conv_direct.py:pack_conv). head_out: z [P][width] T,
// w3 [width][C] f32, b3 [C] f32, pred [P][C] f32, out [P][C] T.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                 // tile rows
constexpr int TW = 16;                 // tile columns
constexpr int THREADS = 128;           // each: rows ty and ty + 8 of column tx
constexpr int CO = 16;                 // output channels per block
constexpr int KC = 16;                 // input channels per shared-memory pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// v as T holds it
template <typename T>
__device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

struct ConvArgs {
  const void* x;
  const void* low;
  const float* w;
  const float* bias;
  void* out;
  int B, H, W, c0, c1, cout, relu;
};

// channel c of up2(low) at full-resolution pixel (gy, gx)
template <typename T>
__device__ float up_value(const ConvArgs& a, int b, int gy, int gx, int c) {
  const T* low = static_cast<const T*>(a.low);
  const int h2 = a.H / 2, w2 = a.W / 2;
  const int k = gy >> 1, j = gx >> 1;
  // out[2k] = 0.25 x[k-1] + 0.75 x[k]; out[2k+1] = 0.75 x[k] + 0.25 x[k+1]
  const int ra = (gy & 1) ? k : max(k - 1, 0);
  const int rb = (gy & 1) ? min(k + 1, h2 - 1) : k;
  const float wa = (gy & 1) ? 0.75f : 0.25f;
  const int ca = (gx & 1) ? j : max(j - 1, 0);
  const int cb = (gx & 1) ? min(j + 1, w2 - 1) : j;
  const float ua = (gx & 1) ? 0.75f : 0.25f;
  float row[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t base = (static_cast<size_t>(b) * h2 + (r ? rb : ra)) * w2;
    const float va = to_f(low[(base + ca) * a.c1 + c]);
    const float vb = to_f(low[(base + cb) * a.c1 + c]);
    row[r] = rnd<T>(__fadd_rn(__fmul_rn(ua, va), __fmul_rn(1.f - ua, vb)));
  }
  return rnd<T>(__fadd_rn(__fmul_rn(wa, row[0]), __fmul_rn(1.f - wa, row[1])));
}

template <typename T, int KS, bool DW>
__global__ void __launch_bounds__(THREADS) conv_kernel(const ConvArgs a) {
  constexpr int R = KS / 2;                      // halo
  constexpr int IW = TW + 2 * R;
  constexpr int IN = (TH + 2 * R) * IW;
  __shared__ float s_in[KC][IN];                 // channel planes of the window
  __shared__ __align__(16) float s_w[KS * KS][KC][CO];

  const int tid = threadIdx.x;
  const int tx = tid % TW;
  const int ty = tid / TW;                       // 0..7
  const int tiles_x = (a.W + TW - 1) / TW;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * CO;
  const int cin = a.c0 + a.c1;
  const T* x = static_cast<const T*>(a.x);
  // depthwise: this block's channels are its own inputs
  const int k_end = DW ? min(co0 + CO, a.cout) : cin;

  float acc[2][CO];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < CO; ++j) acc[p][j] = 0.f;

  for (int kc = DW ? co0 : 0; kc < k_end; kc += KC) {
    __syncthreads();                             // the last pass is done with smem
    for (int idx = tid; idx < IN * KC; idx += THREADS) {
      const int k = idx % KC;
      const int p = idx / KC;
      const int gy = y0 - R + p / IW;
      const int gx = x0 - R + p % IW;
      const int c = kc + k;
      float v = 0.f;
      if (c < k_end && gy >= 0 && gy < a.H && gx >= 0 && gx < a.W) {
        v = c < a.c0 ? to_f(x[((static_cast<size_t>(b) * a.H + gy) * a.W + gx) * a.c0 + c])
                     : up_value<T>(a, b, gy, gx, c - a.c0);
      }
      s_in[k][p] = v;
    }
    if (DW) {
      for (int idx = tid; idx < KS * KS * CO; idx += THREADS) {
        const int tap = idx / CO, j = idx % CO;
        s_w[tap][0][j] = co0 + j < a.cout ? a.w[tap * a.cout + co0 + j] : 0.f;
      }
    } else {
      for (int idx = tid; idx < KS * KS * KC * CO; idx += THREADS) {
        const int j = idx % CO;
        const int k = (idx / CO) % KC;
        const int tap = idx / (CO * KC);
        const int c = kc + k, o = co0 + j;
        s_w[tap][k][j] = (c < cin && o < a.cout)
                             ? a.w[(static_cast<size_t>(tap) * cin + c) * a.cout + o]
                             : 0.f;
      }
    }
    __syncthreads();

    if (DW) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int py = ty + 8 * p;
#pragma unroll
        for (int j = 0; j < CO; ++j) {
          float sum_x = 0.f;
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            float sum_y = 0.f;
#pragma unroll
            for (int ky = 0; ky < 3; ++ky) {
              const float t = __fmul_rn(s_w[ky * 3 + kx][0][j], s_in[j][(py + ky) * IW + tx + kx]);
              sum_y = ky ? __fadd_rn(sum_y, t) : t;
            }
            sum_x = kx ? __fadd_rn(sum_x, sum_y) : sum_y;
          }
          acc[p][j] = sum_x;
        }
      }
    } else {
#pragma unroll 1
      for (int tap = 0; tap < KS * KS; ++tap) {
        const int o0 = (ty + tap / KS) * IW + tx + tap % KS;
        const int o1 = o0 + 8 * IW;
#pragma unroll 4
        for (int k = 0; k < KC; ++k) {
          const float v0 = s_in[k][o0];
          const float v1 = s_in[k][o1];
          const float4* wr = reinterpret_cast<const float4*>(&s_w[tap][k][0]);
#pragma unroll
          for (int q = 0; q < CO / 4; ++q) {
            const float4 wv = wr[q];
            acc[0][4 * q] = fmaf(v0, wv.x, acc[0][4 * q]);
            acc[0][4 * q + 1] = fmaf(v0, wv.y, acc[0][4 * q + 1]);
            acc[0][4 * q + 2] = fmaf(v0, wv.z, acc[0][4 * q + 2]);
            acc[0][4 * q + 3] = fmaf(v0, wv.w, acc[0][4 * q + 3]);
            acc[1][4 * q] = fmaf(v1, wv.x, acc[1][4 * q]);
            acc[1][4 * q + 1] = fmaf(v1, wv.y, acc[1][4 * q + 1]);
            acc[1][4 * q + 2] = fmaf(v1, wv.z, acc[1][4 * q + 2]);
            acc[1][4 * q + 3] = fmaf(v1, wv.w, acc[1][4 * q + 3]);
          }
        }
      }
    }
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int gy = y0 + ty + 8 * p;
    const int gx = x0 + tx;
    if (gy >= a.H || gx >= a.W) continue;
    T* dst = out + ((static_cast<size_t>(b) * a.H + gy) * a.W + gx) * a.cout;
#pragma unroll
    for (int j = 0; j < CO; ++j) {
      const int o = co0 + j;
      if (o >= a.cout) break;
      float v = rnd<T>(rnd<T>(acc[p][j]) + a.bias[o]);
      if (a.relu) v = fmaxf(v, 0.f);
      dst[o] = from_f<T>(v);
    }
  }
}

template <typename T>
__global__ void head_out_kernel(const T* __restrict__ z, const float* __restrict__ w3,
                                const float* __restrict__ b3, const float* __restrict__ pred,
                                T* __restrict__ out, long long npx, int width, int C) {
  const long long p = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (p >= npx) return;
  const T* zp = z + p * width;
  float acc[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < width; ++k) {
    const float v = to_f(zp[k]);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (c < C) acc[c] = fmaf(v, __ldg(w3 + k * C + c), acc[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (c < C) out[p * C + c] = from_f<T>(pred[p * C + c] + (acc[c] + b3[c]));
  }
}

template <typename T>
int launch_conv(const ConvArgs& a, int ks, bool dw, cudaStream_t stream) {
  const long long tiles =
      static_cast<long long>((a.H + TH - 1) / TH) * ((a.W + TW - 1) / TW);
  const int groups = (a.cout + CO - 1) / CO;
  if (tiles > 0x7fffffffLL || a.B > 65535 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid(static_cast<unsigned>(tiles), a.B, groups);
  if (dw) {
    conv_kernel<T, 3, true><<<grid, THREADS, 0, stream>>>(a);
  } else if (ks == 3) {
    conv_kernel<T, 3, false><<<grid, THREADS, 0, stream>>>(a);
  } else {
    conv_kernel<T, 1, false><<<grid, THREADS, 0, stream>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// bf16 != 0: T = __nv_bfloat16, else float. ks 3 or 1; depthwise: ks 3,
// no low, c0 == cout. low == nullptr (c1 == 0), or the up block's second
// input at half resolution (H and W even).
extern "C" int conv_direct(int bf16, int ks, int depthwise, const void* x, const void* low,
                           int B, int H, int W, int c0, int c1, int cout, const void* w,
                           const void* bias, int relu, void* out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c0 < 1 || c1 < 0 || cout < 1 || (ks != 1 && ks != 3) ||
      (low == nullptr) != (c1 == 0) || (c1 && (H % 2 || W % 2)) ||
      (depthwise && (ks != 3 || c1 || c0 != cout))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ConvArgs a;
  a.x = x;
  a.low = low;
  a.w = static_cast<const float*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.B = B;
  a.H = H;
  a.W = W;
  a.c0 = c0;
  a.c1 = c1;
  a.cout = cout;
  a.relu = relu;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_conv<__nv_bfloat16>(a, ks, depthwise, s)
              : launch_conv<float>(a, ks, depthwise, s);
}

// out [npx][C] = T(pred + (z [npx][width] @ w3 [width][C] + b3)), C in 1..3.
extern "C" int head_out_direct(int bf16, const void* z, const void* w3, const void* b3,
                               const void* pred, void* out, long long npx, int width, int C,
                               void* stream) {
  if (npx < 1 || width < 1 || C < 1 || C > 3) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const long long blocks = (npx + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(w3);
  const float* b = static_cast<const float*>(b3);
  const float* p = static_cast<const float*>(pred);
  if (bf16) {
    head_out_kernel<__nv_bfloat16><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(z), w, b, p, static_cast<__nv_bfloat16*>(out), npx,
        width, C);
  } else {
    head_out_kernel<float><<<static_cast<unsigned>(blocks), threads, 0, s>>>(
        static_cast<const float*>(z), w, b, p, static_cast<float*>(out), npx, width, C);
  }
  return static_cast<int>(cudaGetLastError());
}
