// Direct convolutions on the CUDA cores for what the tensor-core kernels do
// not take: f32 compute at any width, and bf16 depthwise heads wider than 64
// and dense heads wider than 256 (sm_90a).
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
// T is float or __nv_bfloat16. Sums are f32 FMAs on the CUDA cores (no
// TF32); the rounding points are the plain versions': for bf16 the conv sum
// rounds, the bias adds, the sum rounds again, then the ReLU; for f32 there
// are none. up2 is the half-pixel 2x bilinear upsample with the TPU kernel's
// rounding points (W pass, round to T, H pass, round), as csrc/double_conv.cu
// builds it; the depthwise sum runs in the TPU kernel's order (per kx the
// three ky terms, then the three kx partial sums), as csrc/refine_head.cu's
// depthwise instance.
//
// What bounds it on the H100. The dense 3x3 and 1x1 modes: f32 FMAs at 67
// TFLOP/s. The f32 w64 head at 1088x1920 does 77,312 FLOP a pixel, 161.5
// GFLOP a frame: 2.4 ms at that peak. The depthwise mode: bytes. Each 64-
// channel f32 intermediate of the composed head is 535 MB a frame (0.16 ms
// at 3.35 TB/s each way), and the depthwise head writes and reads three of
// them (about 1 ms) against 0.4 ms of its FMAs.
//
// What the design does about it:
// - A block computes one pixel tile for up to 64 output channels (grid:
//   tiles x batch x ceil(cout / 64)), so each input window is staged once
//   for 64 channels, and the up block's upsample is computed once per block.
//   Narrow outputs take narrower, taller tiles: 16x16 pixels for 64
//   channels, 32x16 for 32, 64x16 for 16 (NCG groups of 16 channels).
// - 256 threads, each 4 pixels (a column of 4 rows) x 16 channels in
//   registers. For each quad of input channels and each kx it reads the
//   KS + 3 window rows it needs once, 4 channels of one pixel in one 16-byte
//   read, and applies them for every ky: kx slides in registers. Weights are
//   float4 broadcasts (a warp shares its 16 channels). 768 FMAs per 54
//   shared reads in the 3x3 mode, 256 per 20 in the 1x1 mode.
// - The window is stored as channel quads, [quad][row][col][4 x T]: a
//   quarter warp reads 8 neighbouring columns of one row, 8 consecutive
//   16-byte slots, with no bank conflict.
// - Window and weights pass through dynamic shared memory in passes of 8
//   input channels (3x3; up to 32 for 1x1, 32 for depthwise: passes with
//   little arithmetic take more channels), in two buffers (33-85 KB a
//   block, two blocks an SM, above 48 KB by cudaFuncSetAttribute). While a
//   pass computes, the next one arrives by cp.async: one copy per 4
//   channels of an input pixel (16 bytes; 8 in bf16), one per 4 weights of
//   a (tap, input channel) row (a row holds the block's 64 output
//   channels, contiguous). The upsampled channels, the zero halo and
//   inputs whose channel count is not a multiple of 4 go by plain loads
//   and stores. Positions advance by increments: no division per staged
//   element.
// - Depthwise: the same staging over the block's own channels; each pass
//   takes 32 channels, each thread 8 pixels x 4 of them, in the TPU order.
//   1x1: the same tile without a halo.
//
// What it leaves: the composed head's intermediates still go through device
// memory, written once and read once each (fusing conv2 or the pointwise
// conv with the out conv would drop one); head_out_kernel reads its inputs
// as scalars; a block's epilogue does not overlap the next tile's loads.
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

constexpr int THREADS = 256;           // 8 warps
constexpr int TW = 16;                 // tile columns

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
  int vec_x;    // c0 % 4 == 0 and x aligned: a pixel's channel quad in one copy
  int vec_w;    // cout % 4 == 0 and w aligned: 4 weights of a row in one copy
  int vec_out;  // 16 channels (4 for depthwise) of a pixel in 16-byte stores
};

// The tile of a block that computes NCG groups of 16 output channels, each
// group by THREADS / NCG threads of 4 pixels (a column of 4 rows), and the
// input channels KC it stages per pass: 8 for the 3x3 modes; for the 1x1
// mode as many as keep its window at 32 KB; 32 for the depthwise mode,
// whose passes hold little arithmetic.
template <int KS, int NCG, bool DW = false>
struct Tile {
  static constexpr int R = KS / 2;                   // halo
  static constexpr int CO = 16 * NCG;                // output channels
  static constexpr int PER_CG = THREADS / NCG;       // threads per channel group
  static constexpr int TH = 4 * PER_CG / TW;         // rows: 16, 32 or 64
  static constexpr int WR = TH + 2 * R;              // window rows
  static constexpr int WC = TW + 2 * R;              // window columns
  static constexpr int KC = DW ? 32 : KS == 1 ? 8 * NCG : 8;
  static constexpr int NQ = KC / 4;                  // channel quads per pass
  static constexpr int QUADS = NQ * WR * WC;         // window slots of 4 T
};

template <typename T, int KS, int NCG, bool DW>
__host__ __device__ constexpr size_t stage_bytes() {
  using G = Tile<KS, NCG, DW>;
  return (DW ? 9 * G::KC : KS * KS * G::KC * G::CO) * sizeof(float) +
         static_cast<size_t>(G::QUADS) * 4 * sizeof(T);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "n"(BYTES)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a window slot (4 channels of one pixel) as floats
__device__ __forceinline__ void load_quad(const float* p, float v[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load_quad(const __nv_bfloat16* p, float v[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  v[0] = lo.x;
  v[1] = lo.y;
  v[2] = hi.x;
  v[3] = hi.y;
}

__device__ __forceinline__ void zero_quad(float* p) {
  *reinterpret_cast<float4*>(p) = make_float4(0.f, 0.f, 0.f, 0.f);
}

__device__ __forceinline__ void zero_quad(__nv_bfloat16* p) {
  *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
}

// N channels of one output pixel in 16-byte stores (N a multiple of 4 for
// float, of 8 for bf16)
template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* v) {
#pragma unroll
  for (int j = 0; j < N; j += 4) {
    *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

template <int N>
__device__ __forceinline__ void store_vec(__nv_bfloat16* dst, const float* v) {
  if constexpr (N % 8 == 0) {
#pragma unroll
    for (int j = 0; j < N; j += 8) {
      uint32_t u[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(v[j + 2 * k], v[j + 2 * k + 1]);
        u[k] = *reinterpret_cast<const uint32_t*>(&h);
      }
      *reinterpret_cast<uint4*>(dst + j) = make_uint4(u[0], u[1], u[2], u[3]);
    }
  } else {
    static_assert(N == 4, "bf16 stores of 4 or 8k channels");
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    *reinterpret_cast<uint2*>(dst) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b));
  }
}

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

// Issue the window of one pass: input channels kc .. kc + KC - 1 (those
// below k_end) of the tile and its halo, as channel quads. The thread takes
// quad `q` of the window pixels (row, col), (row, col) + THREADS / NQ, ...,
// stepping by increments.
template <typename T, class G>
__device__ __forceinline__ void stage_window(const ConvArgs& a, T* s_in, int b, int y0, int x0,
                                             int kc, int k_end, int q, int row, int col) {
  constexpr int STEP = THREADS / G::NQ;              // window pixels a thread steps
  constexpr int DR = STEP / G::WC, DC = STEP % G::WC;
  const int c = kc + 4 * q;
  if (c >= k_end) return;                            // the pass computes no such quad
  const T* x = static_cast<const T*>(a.x);
  const bool copy = a.vec_x && c + 4 <= a.c0;
  T* dst = s_in + (q * G::WR + row) * G::WC * 4 + col * 4;
  while (row < G::WR) {
    const int gy = y0 - G::R + row, gx = x0 - G::R + col;
    if (gy < 0 || gy >= a.H || gx < 0 || gx >= a.W) {
      zero_quad(dst);
    } else {
      const size_t px = (static_cast<size_t>(b) * a.H + gy) * a.W + gx;
      if (copy) {
        cp_async<4 * sizeof(T)>(dst, x + px * a.c0 + c);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ce = c + e;
          float v = 0.f;
          if (ce < a.c0) {
            v = to_f(x[px * a.c0 + ce]);
          } else if (ce < k_end) {
            v = up_value<T>(a, b, gy, gx, ce - a.c0);
          }
          dst[e] = from_f<T>(v);
        }
      }
    }
    col += DC;
    row += DR;
    if (col >= G::WC) {
      col -= G::WC;
      ++row;
    }
    dst = s_in + (q * G::WR + row) * G::WC * 4 + col * 4;
  }
}

// Issue the dense weights of one pass: rows (tap, kc + k) of the block's CO
// output channels, [tap][k][CO]; zero for input channels past cin and
// output channels past cout.
template <int KS, class G>
__device__ __forceinline__ void stage_weights(const ConvArgs& a, float* s_w, int kc, int co0) {
  constexpr int KC = G::KC, CO = G::CO, SEGS = CO / 4, ROWS = KS * KS * KC;
  const int seg = threadIdx.x % SEGS;
  const int o = co0 + 4 * seg;
  const int cin = a.c0 + a.c1;
  const bool copy = a.vec_w && o + 4 <= a.cout;
  for (int row = threadIdx.x / SEGS; row < ROWS; row += THREADS / SEGS) {
    const int tap = row / KC, c = kc + row % KC;     // KC a power of 2
    float* dst = s_w + row * CO + 4 * seg;
    const float* src = a.w + (static_cast<size_t>(tap) * cin + c) * a.cout + o;
    if (c < cin && copy) {
      cp_async<16>(dst, src);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = c < cin && o + e < a.cout ? src[e] : 0.f;
    }
  }
}

// The dense 3x3 or 1x1 sums of one pass: 4 pixels (rows 4 rg .. 4 rg + 3 of
// column px) x the 16 channels of group cg, over the pass's first nq quads.
template <typename T, int KS, class G>
__device__ __forceinline__ void dense_pass(const T* s_in, const float* s_w, int nq, int cg,
                                           int px, int rg, float (&acc)[4][16]) {
  constexpr int ROWS = 4 + 2 * G::R;                 // window rows a thread reads
#pragma unroll 1
  for (int q = 0; q < nq; ++q) {
    const T* win = s_in + ((q * G::WR + 4 * rg) * G::WC + px) * 4;
    const float* wq = s_w + 4 * q * G::CO + 16 * cg;
#pragma unroll
    for (int kx = 0; kx < KS; ++kx) {
      float v[ROWS][4];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) load_quad(win + (r * G::WC + kx) * 4, v[r]);
#pragma unroll
      for (int ky = 0; ky < KS; ++ky) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float4* wr =
              reinterpret_cast<const float4*>(wq + ((ky * KS + kx) * G::KC + c) * G::CO);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 w = wr[j];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float u = v[i + ky][c];
              acc[i][4 * j] = fmaf(u, w.x, acc[i][4 * j]);
              acc[i][4 * j + 1] = fmaf(u, w.y, acc[i][4 * j + 1]);
              acc[i][4 * j + 2] = fmaf(u, w.z, acc[i][4 * j + 2]);
              acc[i][4 * j + 3] = fmaf(u, w.w, acc[i][4 * j + 3]);
            }
          }
        }
      }
    }
  }
}

// v = act(T(T(sum) + bias[o])), as T holds it
template <typename T>
__device__ __forceinline__ float finish(const ConvArgs& a, float sum, int o) {
  const float v = rnd<T>(rnd<T>(sum) + __ldg(a.bias + o));
  return a.relu ? fmaxf(v, 0.f) : v;
}

// The depthwise 3x3 of one pass, written out: channels kc + 4 dq .. + 3
// (those below k_end) at rows NQ rp .. NQ rp + NQ - 1 of column px, each sum
// in the TPU kernel's order.
template <typename T>
__device__ __forceinline__ void dw_pass(const ConvArgs& a, const T* s_in, const float* s_w,
                                        int b, int y0, int x0, int kc, int k_end) {
  using G = Tile<3, 4, true>;
  constexpr int NQ = G::NQ, RP = G::TH * TW * NQ / THREADS;   // rows a thread takes
  const int dq = threadIdx.x / (THREADS / NQ);
  const int px = threadIdx.x % TW, rp = threadIdx.x % (THREADS / NQ) / TW;
  const int c = kc + 4 * dq;
  if (c >= k_end) return;
  const T* win = s_in + ((dq * G::WR + RP * rp) * G::WC + px) * 4;
  float sx[RP][4];
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    float v[RP + 2][4], w[3][4];
#pragma unroll
    for (int r = 0; r < RP + 2; ++r) load_quad(win + (r * G::WC + kx) * 4, v[r]);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) load_quad(s_w + (ky * 3 + kx) * G::KC + 4 * dq, w[ky]);
#pragma unroll
    for (int i = 0; i < RP; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float sy = __fmul_rn(w[0][e], v[i][e]);
        sy = __fadd_rn(sy, __fmul_rn(w[1][e], v[i + 1][e]));
        sy = __fadd_rn(sy, __fmul_rn(w[2][e], v[i + 2][e]));
        sx[i][e] = kx ? __fadd_rn(sx[i][e], sy) : sy;
      }
    }
  }
  T* out = static_cast<T*>(a.out);
  const int gx = x0 + px;
#pragma unroll
  for (int i = 0; i < RP; ++i) {
    const int gy = y0 + RP * rp + i;
    if (gy >= a.H || gx >= a.W) continue;
    T* dst = out + ((static_cast<size_t>(b) * a.H + gy) * a.W + gx) * a.cout + c;
    float v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) v[e] = c + e < k_end ? finish<T>(a, sx[i][e], c + e) : 0.f;
    if (a.vec_out && c + 4 <= k_end) {
      store_vec<4>(dst, v);
    } else {
      for (int e = 0; e < 4 && c + e < k_end; ++e) dst[e] = from_f<T>(v[e]);
    }
  }
}

template <typename T, int KS, int NCG, bool DW>
__global__ void __launch_bounds__(THREADS, 2) conv_kernel(const ConvArgs a) {
  using G = Tile<KS, NCG, DW>;
  static_assert(!DW || (KS == 3 && NCG == 4), "depthwise: 3x3 on 16x16 tiles");
  constexpr int KC = G::KC, NQ = G::NQ;
  constexpr int W_FLOATS = DW ? 9 * KC : KS * KS * KC * G::CO;
  constexpr size_t STAGE = stage_bytes<T, KS, NCG, DW>();
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x;
  const int tiles_x = (a.W + TW - 1) / TW;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x) * G::TH;
  const int b = blockIdx.y;
  const int co0 = blockIdx.z * G::CO;
  // depthwise: the block's channels are its own inputs
  const int k_begin = DW ? co0 : 0;
  const int k_end = DW ? min(co0 + G::CO, a.cout) : a.c0 + a.c1;
  const int npass = (k_end - k_begin + KC - 1) / KC;
  // where this thread starts staging the window: quad q of pixel (row, col)
  const int sq = tid % NQ, spix = tid / NQ;
  const int srow = spix / G::WC, scol = spix % G::WC;
  // what it computes (dense): 4 pixels of column px, channel group cg
  const int cg = tid / G::PER_CG, px = tid % TW, rg = tid % G::PER_CG / TW;

  auto s_w = [&](int s) { return reinterpret_cast<float*>(smem + s * STAGE); };
  auto s_in = [&](int s) {
    return reinterpret_cast<T*>(smem + s * STAGE + W_FLOATS * sizeof(float));
  };
  // issue pass i into buffer i & 1, as one cp.async group
  auto stage = [&](int i) {
    const int s = i & 1, kc = k_begin + i * KC;
    if constexpr (DW) {
      for (int j = tid; j < 9 * KC; j += THREADS) {
        const int c = kc + j % KC;
        s_w(s)[j] = c < k_end ? a.w[(j / KC) * a.cout + c] : 0.f;
      }
    } else {
      stage_weights<KS, G>(a, s_w(s), kc, co0);
    }
    stage_window<T, G>(a, s_in(s), b, y0, x0, kc, k_end, sq, srow, scol);
    cp_async_commit();
  };

  float acc[4][16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[i][j] = 0.f;

  stage(0);
  for (int i = 0; i < npass; ++i) {
    if (i + 1 < npass) {
      stage(i + 1);                                  // overlaps this pass
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();                                 // pass i has landed
    const int s = i & 1, kc = k_begin + i * KC;
    if constexpr (DW) {
      dw_pass<T>(a, s_in(s), s_w(s), b, y0, x0, kc, k_end);
    } else {
      dense_pass<T, KS, G>(s_in(s), s_w(s), min(NQ, (k_end - kc + 3) / 4), cg, px, rg, acc);
    }
    __syncthreads();                                 // buffer i & 1 is free again
  }
  if constexpr (!DW) {
    T* out = static_cast<T*>(a.out);
    const int gx = x0 + px;
    const int ob = co0 + 16 * cg;
    if (gx >= a.W || ob >= a.cout) return;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int gy = y0 + 4 * rg + i;
      if (gy >= a.H) break;
      T* dst = out + ((static_cast<size_t>(b) * a.H + gy) * a.W + gx) * a.cout + ob;
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        v[j] = ob + j < a.cout ? finish<T>(a, acc[i][j], ob + j) : 0.f;
      }
      if (a.vec_out && ob + 16 <= a.cout) {
        store_vec<16>(dst, v);
      } else {
        for (int j = 0; j < 16 && ob + j < a.cout; ++j) dst[j] = from_f<T>(v[j]);
      }
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

template <typename T, int KS, int NCG, bool DW>
int launch(const ConvArgs& a, cudaStream_t stream) {
  using G = Tile<KS, NCG, DW>;
  const long long tiles =
      static_cast<long long>((a.H + G::TH - 1) / G::TH) * ((a.W + TW - 1) / TW);
  const int groups = (a.cout + G::CO - 1) / G::CO;
  if (tiles > 0x7fffffffLL || a.B > 65535 || groups > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(2 * stage_bytes<T, KS, NCG, DW>());
  const cudaError_t err = cudaFuncSetAttribute(
      conv_kernel<T, KS, NCG, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles), a.B, groups);
  conv_kernel<T, KS, NCG, DW><<<grid, THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int KS>
int launch_dense(const ConvArgs& a, cudaStream_t stream) {
  if (a.cout <= 16) return launch<T, KS, 1, false>(a, stream);
  if (a.cout <= 32) return launch<T, KS, 2, false>(a, stream);
  return launch<T, KS, 4, false>(a, stream);
}

template <typename T>
int launch_conv(ConvArgs& a, int ks, bool dw, cudaStream_t stream) {
  constexpr uintptr_t quad = 4 * sizeof(T);
  a.vec_x = a.c0 % 4 == 0 && reinterpret_cast<uintptr_t>(a.x) % quad == 0;
  a.vec_w = a.cout % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0;
  a.vec_out = a.cout % (16 / sizeof(T)) == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  if (dw) return launch<T, 3, 4, true>(a, stream);
  return ks == 3 ? launch_dense<T, 3>(a, stream) : launch_dense<T, 1>(a, stream);
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
