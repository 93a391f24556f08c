// The U-Net core's fused double conv and decoder up block for Hopper
// (sm_90a).
//
// Replaces ops/pallas/dconv_fused.py of the JAX package:
//   double_conv_fused    (body _kernel):     out = DC(x)
//   up_double_conv_fused (body _up_kernel):  out = DC(concat(skip, up2(low)))
// with, per conv, bf16 operands, f32 accumulation and SAME zero padding,
//
//   z1  = relu(bf16(bf16(conv3x3(in, Cin -> mid)) + b1))   zero outside the image
//   out = relu(bf16(bf16(conv3x3(z1, mid -> Cout)) + b2))
//
// and up2 the half-pixel 2x bilinear upsample with the TPU kernel's rounding
// points: a two-tap lerp along W in f32 over the bf16 low rows, rounded to
// bf16, then 0.25/0.75 along H in f32 over those values (edge rows and
// columns clamped), rounded to bf16. Every product is exact in f32, so each
// up value equals the plain version's bit for bit.
//
// What bounds it on the H100: at 1088x1920 with the s2d-4 production core
// (base 64), each level does 14.4 GFLOP (inc 32->64->64 at 272x480, down1
// 64->128->128 at 136x240, down2 128->256->256 at 68x120), up3 24.1 and up4
// 28.9, 14.6-29.2 us at the 989 TFLOP/s bf16 tensor-core peak, against
// 6.3-37.6 MB of input and output (1.9-11.2 us at 3.35 TB/s): compute-bound.
// Unfused, each mid activation and the up block's upsampled and
// concatenated tensors would make a round trip through device memory.
//
// What the design does about it:
// - Persistent blocks walk over 16x16 output tiles (16 rows x 16 columns),
//   or 8x16 where the 16-row tile does not fit shared memory (down2, up3),
//   the tile size picked from the channel counts. For each tile a block loads
//   the input tile with a 2-pixel halo into shared memory, zero outside the
//   image; for the up block the load builds the skip channels and then the
//   upsampled channels from `low`, so neither the upsampled tensor nor the
//   concat is ever written to device memory. conv1 runs over the tile plus
//   a 1-pixel halo and leaves z1 in shared memory (zero outside the image:
//   conv2's SAME padding); conv2 writes only the output tile.
// - Both convs are implicit GEMMs on the tensor cores with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate), A and B fragments by
//   ldmatrix. M is the tile's pixels (conv1: the 18-wide window), N the
//   output channels in passes of 64, K = 9 taps x the input channels.
//   Pixel rows in shared memory are padded by 16 bytes so the eight rows of
//   an 8x8 matrix fall in distinct banks.
// - The weights do not fit on chip at every level (down2's pair is 1.77 MB
//   in bf16), so they stream through a two-stage shared-memory ring in
//   chunks of one tap x 64 input channels x 64 output channels, by cp.async
//   one chunk ahead of the mma loop.
// - Simple before fast: the halo load, the two convs and the stores do not
//   overlap, one block of 8 warps runs per SM, and each N pass reloads its
//   A fragments. wgmma, TMA-fed weights and a pipeline that overlaps one
//   tile's load with the previous tile's convs are the next step.
//
// Layouts: x [B,H,W,c0] bf16 (the skip for the up block), low
// [B,H/2,W/2,c1] bf16, out [B,H,W,cout] bf16, all channels-last and
// contiguous, every channel count a multiple of 8. Weights as
// ops/dconv_fused.py:pack_dconv_weights builds them, with k0p, k1p, midp and
// coutp the channel counts rounded up to 16 (the padding is zeros):
// w1 [9][midp][k0p + k1p] (tap, out, in: skip channels, then up channels),
// w2 [9][coutp][midp], b1 [midp], b2 [coutp], bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;                 // output tile columns (one m16 tile row)
constexpr int HALO_W = TW + 4;         // input window: two stacked 3x3 convs
constexpr int Z1_W = TW + 2;           // conv1 window: one 3x3 halo
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int NC = 64;                 // output channels per N pass
constexpr int KC = 64;                 // input channels per weight chunk
constexpr int WRS = KC + 8;            // weight chunk row stride (bf16)
constexpr int MT1 = 3;                 // conv1 m16 tiles per warp (21 at 16 rows)
constexpr int MT2 = 2;                 // conv2 m16 tiles per warp (16 at 16 rows)
constexpr int SMEM_LIMIT = 232448;     // dynamic shared memory of one H100 block

struct Args {
  const __nv_bfloat16* x;
  const __nv_bfloat16* low;
  const __nv_bfloat16* w1;
  const __nv_bfloat16* b1;
  const __nv_bfloat16* w2;
  const __nv_bfloat16* b2;
  __nv_bfloat16* out;
  int B, H, W, th;
  int c0, c1, k0p, k1p, midp, cout, coutp;
};

__host__ __device__ inline int ceil16(int c) { return (c + 15) / 16 * 16; }

__host__ __device__ inline size_t smem_bytes(int th, int kin, int midp) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>((th + 4) * HALO_W) * (kin + 8) +
          static_cast<size_t>((th + 2) * Z1_W) * (midp + 8) + 2 * NC * WRS);
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Eight channels of the bf16 vector at p, as floats.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// Channels [cq, cq + 8) of up2(low) at full-resolution pixel (gy, gx).
__device__ uint4 upsample8(const Args& a, int b, int gy, int gx, int cq) {
  const int h2 = a.H / 2, w2 = a.W / 2;
  const int k = gy >> 1, j = gx >> 1;
  // out[2k] = 0.25 x[k-1] + 0.75 x[k]; out[2k+1] = 0.75 x[k] + 0.25 x[k+1]
  const int ra = (gy & 1) ? k : max(k - 1, 0);
  const int rb = (gy & 1) ? min(k + 1, h2 - 1) : k;
  const float wa = (gy & 1) ? 0.75f : 0.25f;
  const int ca = (gx & 1) ? j : max(j - 1, 0);
  const int cb = (gx & 1) ? min(j + 1, w2 - 1) : j;
  const float ua = (gx & 1) ? 0.75f : 0.25f;
  float row[2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t base = (static_cast<size_t>(b) * h2 + (r ? rb : ra)) * w2;
    float va[8], vb[8];
    load8(a.low + (base + ca) * a.c1 + cq, va);
    load8(a.low + (base + cb) * a.c1 + cq, vb);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      row[r][i] = round_bf16(__fadd_rn(__fmul_rn(ua, va[i]), __fmul_rn(1.f - ua, vb[i])));
    }
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[i] = pack_bf16(__fadd_rn(__fmul_rn(wa, row[0][2 * i]), __fmul_rn(1.f - wa, row[1][2 * i])),
                     __fadd_rn(__fmul_rn(wa, row[0][2 * i + 1]),
                               __fmul_rn(1.f - wa, row[1][2 * i + 1])));
  }
  return out;
}

// One conv of the block as an implicit GEMM: A rows are the m_n pixels of an
// m_w-wide grid over shared memory s_a (a_w pixels wide, a_rs bf16 a pixel);
// B streams from gw [9][n_total][k_ch] in (tap, 64-channel) chunks. For each
// N pass of up to NC channels, epi(nc, nw, mtile_of, acc) takes the sums.
template <int MT, class Epi>
__device__ __forceinline__ void conv_pass(const __nv_bfloat16* s_a, int a_rs, int a_w,
                                          int m_w, int m_n,
                                          const __nv_bfloat16* __restrict__ gw,
                                          int n_total, int k_ch, __nv_bfloat16* s_w,
                                          Epi epi) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int mtiles = (m_n + 15) / 16;
  int abase[MT];                       // A window index of this lane's row
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = min((warp + WARPS * i) * 16 + (lane & 15), m_n - 1);
    abase[i] = (m / m_w) * a_w + m % m_w;
  }
  const int kchunks = (k_ch + KC - 1) / KC;
  const int nchunks = 9 * kchunks;
  for (int nc = 0; nc < n_total; nc += NC) {
    const int nw = min(NC, n_total - nc);
    auto load_chunk = [&](int ci) {
      const int tap = ci / kchunks;
      const int kc = (ci % kchunks) * KC;
      const int kp = min(KC, k_ch - kc) / 8;        // 16-byte pieces a row
      __nv_bfloat16* dst = s_w + (ci & 1) * NC * WRS;
      const __nv_bfloat16* src = gw + (static_cast<size_t>(tap) * n_total + nc) * k_ch + kc;
      for (int idx = tid; idx < nw * kp; idx += THREADS) {
        const int n = idx / kp;
        const int q = idx - n * kp;
        cp_async16(dst + n * WRS + q * 8, src + static_cast<size_t>(n) * k_ch + q * 8);
      }
      cp_async_commit();
    };
    float acc[MT][NC / 8][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    load_chunk(0);
    for (int ci = 0; ci < nchunks; ++ci) {
      if (ci + 1 < nchunks) {
        load_chunk(ci + 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const int tap = ci / kchunks;
      const int kc = (ci % kchunks) * KC;
      const int kw = min(KC, k_ch - kc);
      const int toff = (tap / 3) * a_w + tap % 3;
      const __nv_bfloat16* sw = s_w + (ci & 1) * NC * WRS;
      for (int kk = 0; kk < kw; kk += 16) {
        uint32_t bfr[NC / 8][2];
#pragma unroll
        for (int j = 0; j < NC / 8; j += 2) {
          if (j * 8 < nw) {
            uint32_t r[4];
            const int q = lane / 8;
            ldmatrix_x4(r, sw + ((j + (q >> 1)) * 8 + lane % 8) * WRS + kk + (q & 1) * 8);
            bfr[j][0] = r[0];
            bfr[j][1] = r[1];
            bfr[j + 1][0] = r[2];
            bfr[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (warp + WARPS * i < mtiles) {
            uint32_t af[4];
            ldmatrix_x4(af, s_a + (abase[i] + toff) * a_rs + kc + kk + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < NC / 8; ++j) {
              if (j * 8 < nw) mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
            }
          }
        }
      }
      __syncthreads();                 // this stage is refilled two chunks on
    }
    epi(nc, nw, acc);
  }
}

__global__ void __launch_bounds__(THREADS, 1) double_conv_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int th = a.th;
  const int kin = a.k0p + a.k1p;
  const int rsi = kin + 8;             // padded pixel row strides (bf16)
  const int rsz = a.midp + 8;
  const int halo_n = (th + 4) * HALO_W;
  const int z1_n = (th + 2) * Z1_W;
  __nv_bfloat16* s_in = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_z1 = s_in + halo_n * rsi;
  __nv_bfloat16* s_w = s_z1 + z1_n * rsz;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;              // mma groupID
  const int t = lane % 4;              // mma thread in group
  const int H = a.H, W = a.W;
  const int p0 = a.k0p / 8;
  const int pieces = p0 + a.k1p / 8;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + th - 1) / th;
  const int ntiles = a.B * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int y0 = rem / tiles_x * th;
    const int x0 = rem % tiles_x * TW;

    __syncthreads();                   // the previous tile is done with smem

    // 1. the input window, zero outside the image and in the padding
    for (int idx = tid; idx < halo_n * pieces; idx += THREADS) {
      const int p = idx / pieces;
      const int q = idx - p * pieces;
      const int gy = y0 - 2 + p / HALO_W;
      const int gx = x0 - 2 + p % HALO_W;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        if (q < p0) {
          if (q * 8 < a.c0) {
            v = __ldg(reinterpret_cast<const uint4*>(
                a.x + ((static_cast<size_t>(b) * H + gy) * W + gx) * a.c0 + q * 8));
          }
        } else if ((q - p0) * 8 < a.c1) {
          v = upsample8(a, b, gy, gx, (q - p0) * 8);
        }
      }
      *reinterpret_cast<uint4*>(s_in + p * rsi + q * 8) = v;
    }

    // 2. conv1 over the (th+2) x 18 window -> z1 in shared memory
    conv_pass<MT1>(s_in, rsi, HALO_W, Z1_W, z1_n, a.w1, a.midp, kin, s_w,
                   [&](int nc, int nw, float (&acc)[MT1][NC / 8][4]) {
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (warp + WARPS * i) * 16 + g + 8 * h;
          if (m >= z1_n) continue;
          const int gy = y0 - 1 + m / Z1_W;
          const int gx = x0 - 1 + m % Z1_W;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            if (j * 8 >= nw) continue;
            const int o = nc + j * 8 + 2 * t;
            float v0 = 0.f, v1 = 0.f;
            if (inside) {
              v0 = fmaxf(round_bf16(round_bf16(acc[i][j][2 * h]) + __bfloat162float(a.b1[o])), 0.f);
              v1 = fmaxf(round_bf16(round_bf16(acc[i][j][2 * h + 1]) +
                                    __bfloat162float(a.b1[o + 1])),
                         0.f);
            }
            *reinterpret_cast<uint32_t*>(s_z1 + m * rsz + o) = pack_bf16(v0, v1);
          }
        }
      }
    });

    // 3. conv2 over the th x 16 tile -> the output
    conv_pass<MT2>(s_z1, rsz, Z1_W, TW, th * TW, a.w2, a.coutp, a.midp, s_w,
                   [&](int nc, int nw, float (&acc)[MT2][NC / 8][4]) {
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (warp + WARPS * i) * 16 + g + 8 * h;
          if (m >= th * TW) continue;
          const int gy = y0 + m / TW;
          const int gx = x0 + m % TW;
          if (gy >= H || gx >= W) continue;
          __nv_bfloat16* dst = a.out + ((static_cast<size_t>(b) * H + gy) * W + gx) * a.cout;
#pragma unroll
          for (int j = 0; j < NC / 8; ++j) {
            const int o = nc + j * 8 + 2 * t;
            if (j * 8 >= nw || o >= a.cout) continue;
            const float v0 = fmaxf(
                round_bf16(round_bf16(acc[i][j][2 * h]) + __bfloat162float(a.b2[o])), 0.f);
            const float v1 = fmaxf(
                round_bf16(round_bf16(acc[i][j][2 * h + 1]) + __bfloat162float(a.b2[o + 1])),
                0.f);
            *reinterpret_cast<uint32_t*>(dst + o) = pack_bf16(v0, v1);
          }
        }
      }
    });
  }
}

}  // namespace

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// low == nullptr (c1 == 0): the double conv of x. Otherwise the up block
// over concat(x, up2(low)), with H and W even and low [B,H/2,W/2,c1].
extern "C" int double_conv_bf16(const void* x, const void* low, int B, int H, int W,
                                int c0, int c1, int mid, int cout, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* out, void* stream) {
  if (B < 1 || H < 1 || W < 1 || c0 < 8 || c0 % 8 || c1 < 0 || c1 % 8 || mid < 8 ||
      mid % 8 || cout < 8 || cout % 8 || (low == nullptr) != (c1 == 0) ||
      (c1 && (H % 2 || W % 2))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.low = static_cast<const __nv_bfloat16*>(low);
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.b1 = static_cast<const __nv_bfloat16*>(b1);
  a.w2 = static_cast<const __nv_bfloat16*>(w2);
  a.b2 = static_cast<const __nv_bfloat16*>(b2);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.B = B;
  a.H = H;
  a.W = W;
  a.c0 = c0;
  a.c1 = c1;
  a.k0p = ceil16(c0);
  a.k1p = c1 ? ceil16(c1) : 0;
  a.midp = ceil16(mid);
  a.cout = cout;
  a.coutp = ceil16(cout);
  const int kin = a.k0p + a.k1p;
  a.th = smem_bytes(16, kin, a.midp) <= SMEM_LIMIT ? 16 : 8;
  const size_t smem = smem_bytes(a.th, kin, a.midp);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);

  cudaError_t err = cudaFuncSetAttribute(
      double_conv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, double_conv_kernel,
                                                           THREADS, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles =
      static_cast<long long>(B) * ((H + a.th - 1) / a.th) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(ntiles < slots ? ntiles : slots);
  double_conv_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
