// Fused full-resolution refinement head for Hopper (sm_90a).
//
// Replaces ops/pallas/refine_fused.py:refine_head_fused of the JAX package
// (its Pallas body _kernel): with z = concat(pred, *planes) per pixel,
//
//   z1  = relu(bf16(bf16(conv3x3(z,  nplanes -> WD)) + b1))
//   z2  = relu(bf16(bf16(conv3x3(z1, WD -> WD))      + b2))
//   out = bf16(pred + (conv1x1_f32(z2, WD -> C) + b3))
//
// with SAME zero padding, bf16 operands, f32 accumulation, the f32 out conv
// over the bf16 z2 and the f32 residual: the numerics of the Flax head
// (models/unet.py, refine branch; models/flow.py, refine), not those of
// the TPU kernel's compiled fast path, which rounds the out-conv weights to
// bf16. The head width WD is a template parameter with two instances: 64
// (the U-Net production head, 3 or 9 planes) and 16 (the flow production
// head, 5 or 15 planes). A third instance, DW, is the depthwise head
// (ModelConfig(refine_depthwise=True), the TPU kernel's refine2_dw and
// refine2_pw) at WD=64: conv2 becomes
//
//   zdw = bf16(bf16(dwconv3x3_f32(z1)) + bdw)      taps bf16, kept in f32
//   z2  = relu(bf16(bf16(conv1x1(zdw, WD -> WD)) + bpw))
//
// the depthwise sum in f32 in the TPU kernel's order (per kx the three ky
// terms, then the three kx partial sums), the pointwise conv on the tensor
// cores.
//
// What bounds it on the H100: at 1088x1920 with 3 planes, C=1 and WD=64
// the head does 3,456 + 73,728 + 128 = 77,312 FLOP per pixel, 161.5 GFLOP
// per frame, or 0.163 ms at the 989 TFLOP/s bf16 tensor-core peak. Its own
// device-memory traffic is only the f32 prediction, the two bf16 frames and
// the bf16 output, 10 bytes per pixel or 20.9 MB per frame (6.2 us at
// 3.35 TB/s): the head is compute-bound. Left unfused, each of its two
// 64-channel bf16 activations would be 267 MB per frame. At WD=16 with 5
// planes (the flow head) it is 6,080 FLOP per pixel, 12.7 GFLOP or 12.8 us
// per frame, against 18 bytes per pixel (f32 prediction and warped frames,
// bf16 frames and output; 37.6 MB, 11.2 us): about as much traffic as
// arithmetic.
//
// What the design does about it:
// - Both activations stay on chip, as in the TPU kernel. A block works on
//   16x16 output tiles: it loads the 20x20xnplanes input halo into shared
//   memory (zero outside the image), computes the 18x18xWD conv1
//   activation into shared memory as bf16 (zero outside the image, which
//   is conv2's SAME padding), then conv2, the bias/ReLU, the 1x1 out conv
//   and the residual for the tile's 256 pixels. Only the planes are read
//   and only the output is written.
// - Both 3x3 convs run on the tensor cores as implicit GEMMs with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate). conv2: M = 256 pixels,
//   N = WD, K = 9 taps x WD channels; each warp owns two tile rows (two
//   m16 tiles) and all WD output channels, so the out conv reduces within
//   the warp (quad shuffles). A and B fragments come from shared memory by
//   ldmatrix; rows are padded to WD + 8 bf16 (144 bytes at WD=64, 48 at
//   WD=16) so the eight rows of each 8x8 matrix fall in distinct banks
//   (word offsets 4i, resp. 12i mod 32). conv1: M = 324 window pixels,
//   K = 9 x nplanes padded to 16, A gathered through a tap offset table.
// - Blocks are persistent and load the WDxWDx9 conv2 and the conv1
//   weights into shared memory once, not once per tile. At WD=64 one
//   block fits an SM (137 KB of shared memory at 3 planes); at WD=16 a block
//   needs about 28 KB, so the kernel is compiled for four blocks per SM
//   (at most 64 registers a thread) and the occupancy query sizes the grid.
// - The depthwise instance (3 planes, 1088x1920) does 3,456 + 1,152 (f32,
//   on the CUDA cores) + 8,192 + 128 FLOP per pixel: 24.6 GFLOP on the
//   tensor cores (24.9 us) and 2.41 GFLOP of f32 (36.0 us at 67 TFLOP/s),
//   with the dense head's 20.9 MB of traffic. Its conv1 is the dense
//   head's; the depthwise 3x3 reads z1 from shared memory, one warp per
//   pixel and two channels per lane (conflict-free 32-bit reads), and
//   writes zdw to shared memory, where the pointwise conv takes it as the
//   A operand of one k=WD GEMM per tile row. Without the 9-tap w2 it needs
//   about 100 KB of shared memory, so two blocks share an SM.
// - Still far from the bound: shared-memory bandwidth feeds mma.sync at
//   about 0.9 MB of fragment reads per tile, and the phases of a tile do
//   not overlap. wgmma and TMA are the next step.
//
// Layouts: pred [B,H,W,C] f32; planes [B,H,W,C] (up to 4), each bf16, or
// f32 where its bit in plane_f32 is set (the flow sampler's f32 warped
// frames go in as they are and round to bf16 in the halo load, as a cast
// would); concat channel p is (k = p / C, c = p % C) with k = 0 the
// prediction. w1 [WD][9*nplanes] bf16 (out, then tap-major, plane-minor),
// w2 [9][WD][WD] bf16 (tap, out, in), b1/b2 [WD] bf16, w3 [WD][C] f32,
// b3 [C] f32. Output [B,H,W,C] bf16. The depthwise instance takes wpw
// [WD][WD] bf16 (out, in) and bpw in place of w2 and b2, and wdw [9][WD]
// f32 (tap, channel) and bdw [WD] bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                 // output tile rows
constexpr int TW = 16;                 // output tile columns (one m16 tile)
constexpr int HALO_W = TW + 4;         // input window (two stacked 3x3)
constexpr int HALO_N = (TH + 4) * HALO_W;
constexpr int Z1_W = TW + 2;           // conv1 window (one 3x3 halo)
constexpr int Z1_N = (TH + 2) * Z1_W;  // 324 pixels
constexpr int Z1_MT = (Z1_N + 15) / 16;
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int MAX_EXTRA = 4;           // planes besides the prediction
constexpr int MAX_C = 3;
constexpr int MAX_NPLANES = (1 + MAX_EXTRA) * MAX_C;

static_assert(TH == 2 * WARPS, "each warp owns two tile rows");

struct Planes {
  const void* p[MAX_EXTRA];
  int f32;                             // bit k - 1: plane k is f32
};

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(uint16_t lo, uint16_t hi) {
  return static_cast<uint32_t>(lo) | (static_cast<uint32_t>(hi) << 16);
}

struct Smem {
  __nv_bfloat16* w2;    // [9*WD][RS]   conv2 weights, (tap, out) rows (DW: wpw)
  __nv_bfloat16* z1;    // [Z1_N][RS]   conv1 activation, pixel rows
  __nv_bfloat16* zdw;   // [TH*TW][RS]  DW: depthwise output, pixel rows
  __nv_bfloat16* w1;    // [WD][k1s]    conv1 weights, out rows
  uint16_t* in;         // [nplanes][HALO_N] input halo (bf16 bits)
  int* koff;            // [k1p]        halo offset of each conv1 K index
};

__host__ __device__ inline int k1_padded(int nplanes) {
  return (9 * nplanes + 15) / 16 * 16;
}

// rows of conv2's weights in shared memory (the 1x1 wpw for DW), and of
// the depthwise output
template <int WD, bool DW>
__host__ __device__ constexpr int w2_rows() { return DW ? WD : 9 * WD; }
template <bool DW>
__host__ __device__ constexpr int zdw_rows() { return DW ? TH * TW : 0; }

template <int WD, bool DW>
__host__ __device__ inline size_t smem_bytes(int nplanes) {
  constexpr int RS = WD + 8;           // padded row stride (bf16) of z1/w2
  const int k1p = k1_padded(nplanes);
  return sizeof(__nv_bfloat16) * ((w2_rows<WD, DW>() + Z1_N + zdw_rows<DW>()) * RS +
                                  WD * (k1p + 8)) +
         sizeof(uint16_t) * nplanes * HALO_N + sizeof(int) * k1p;
}

// compiled for 1 block per SM at WD=64 (shared memory allows no more), 2
// for the depthwise head and 4 at WD=16, which caps those instances at 128
// and 64 registers a thread
template <int WD, bool DW>
__global__ void __launch_bounds__(THREADS, DW ? 2 : (WD == 64 ? 1 : 4))
refine_head_kernel(const float* __restrict__ pred, Planes planes,
                   int nplanes, int C,
                   const __nv_bfloat16* __restrict__ w1,
                   const __nv_bfloat16* __restrict__ b1,
                   const __nv_bfloat16* __restrict__ w2,
                   const __nv_bfloat16* __restrict__ b2,
                   const float* __restrict__ wdw,
                   const __nv_bfloat16* __restrict__ bdw,
                   const float* __restrict__ w3,
                   const float* __restrict__ b3,
                   __nv_bfloat16* __restrict__ out, int B, int H, int W) {
  static_assert(WD % 16 == 0, "two n8 tiles per ldmatrix, k16 steps");
  static_assert(!DW || WD == 64, "one channel pair per lane in the depthwise step");
  constexpr int RS = WD + 8;           // padded row stride (bf16) of z1/w2
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int k1 = 9 * nplanes;
  const int k1p = k1_padded(nplanes);
  const int k1s = k1p + 8;             // padded conv1 weight row (bf16)
  Smem s;
  s.w2 = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  s.z1 = s.w2 + w2_rows<WD, DW>() * RS;
  s.zdw = s.z1 + Z1_N * RS;
  s.w1 = s.zdw + zdw_rows<DW>() * RS;
  s.in = reinterpret_cast<uint16_t*>(s.w1 + WD * k1s);
  s.koff = reinterpret_cast<int*>(s.in + nplanes * HALO_N);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;              // mma groupID
  const int t = lane % 4;              // mma thread in group

  // weights, once per block: w2 rows of WD in 16-byte chunks
  for (int idx = tid; idx < w2_rows<WD, DW>() * (WD / 8); idx += THREADS) {
    const int row = idx / (WD / 8);
    const int ch = idx % (WD / 8);
    *reinterpret_cast<uint4*>(s.w2 + row * RS + ch * 8) =
        __ldg(reinterpret_cast<const uint4*>(w2 + row * WD) + ch);
  }
  for (int idx = tid; idx < WD * k1p; idx += THREADS) {
    const int o = idx / k1p;
    const int k = idx % k1p;
    s.w1[o * k1s + k] = k < k1 ? w1[o * k1 + k] : __float2bfloat16_rn(0.f);
  }
  for (int k = tid; k < k1p; k += THREADS) {
    int off = -1;
    if (k < k1) {
      const int tap = k / nplanes;
      off = (k % nplanes) * HALO_N + (tap / 3) * HALO_W + tap % 3;
    }
    s.koff[k] = off;
  }
  // DW: this lane's channel pair's depthwise taps and bias
  float wd[9][2] = {};
  float bd[2] = {0.f, 0.f};
  if (DW) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      wd[tap][0] = wdw[tap * WD + 2 * lane];
      wd[tap][1] = wdw[tap * WD + 2 * lane + 1];
    }
    bd[0] = __bfloat162float(bdw[2 * lane]);
    bd[1] = __bfloat162float(bdw[2 * lane + 1]);
  }

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int y0 = rem / tiles_x * TH;
    const int x0 = rem % tiles_x * TW;
    const size_t img = static_cast<size_t>(b) * H * W;

    __syncthreads();                   // the previous tile is done with smem

    // 1. input halo as bf16 bits; the prediction rounds to bf16 here
    for (int idx = tid; idx < nplanes * HALO_N; idx += THREADS) {
      const int p = idx / HALO_N;
      const int r = idx - p * HALO_N;
      const int gy = y0 - 2 + r / HALO_W;
      const int gx = x0 - 2 + r % HALO_W;
      __nv_bfloat16 v = __float2bfloat16_rn(0.f);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
        const int k = p / C;
        const size_t off =
            (img + static_cast<size_t>(gy) * W + gx) * C + (p - k * C);
        if (k == 0) {
          v = __float2bfloat16_rn(pred[off]);
        } else if ((planes.f32 >> (k - 1)) & 1) {
          v = __float2bfloat16_rn(static_cast<const float*>(planes.p[k - 1])[off]);
        } else {
          v = static_cast<const __nv_bfloat16*>(planes.p[k - 1])[off];
        }
      }
      s.in[idx] = __bfloat16_as_ushort(v);
    }
    __syncthreads();

    // 2. conv1: m16 tiles of window pixels, round-robin over the warps
    for (int mt = warp; mt < Z1_MT; mt += WARPS) {
      int base[2];                     // halo offset of rows g and g+8
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        base[h] = m < Z1_N ? (m / Z1_W) * HALO_W + m % Z1_W : -1;
      }
      float acc[WD / 8][4] = {};
      for (int k0 = 0; k0 < k1p; k0 += 16) {
        int ko[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) ko[q] = s.koff[k0 + 2 * t + (q & 1) + 8 * (q >> 1)];
        uint16_t e[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            e[h][q] = (base[h] >= 0 && ko[q] >= 0) ? s.in[ko[q] + base[h]] : 0;
          }
        }
        // a0: (g, 2t..2t+1), a1: (g+8, 2t..), a2: (g, 2t+8..), a3: (g+8, 2t+8..)
        const uint32_t a[4] = {pack_raw(e[0][0], e[0][1]), pack_raw(e[1][0], e[1][1]),
                               pack_raw(e[0][2], e[0][3]), pack_raw(e[1][2], e[1][3])};
#pragma unroll
        for (int j = 0; j < WD / 8; j += 2) {
          uint32_t bf[4];
          const int q = lane / 8;
          ldmatrix_x4(bf, s.w1 + ((j + (q >> 1)) * 8 + lane % 8) * k1s + k0 + (q & 1) * 8);
          mma_bf16(acc[j], a, bf[0], bf[1]);
          mma_bf16(acc[j + 1], a, bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = mt * 16 + g + 8 * h;
        if (m >= Z1_N) continue;
        const int gy = y0 - 1 + m / Z1_W;
        const int gx = x0 - 1 + m % Z1_W;
        const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
        for (int j = 0; j < WD / 8; ++j) {
          const int o = j * 8 + 2 * t;
          float v0 = 0.f, v1 = 0.f;
          if (inside) {
            v0 = fmaxf(round_bf16(round_bf16(acc[j][2 * h]) + __bfloat162float(b1[o])), 0.f);
            v1 = fmaxf(round_bf16(round_bf16(acc[j][2 * h + 1]) + __bfloat162float(b1[o + 1])), 0.f);
          }
          *reinterpret_cast<uint32_t*>(s.z1 + m * RS + o) = pack_bf16(v0, v1);
        }
      }
    }
    __syncthreads();

    // 3. DW: the depthwise 3x3 in f32, one warp per pixel, channels
    // 2*lane and 2*lane+1, into zdw
    if (DW) {
      for (int p = warp; p < TH * TW; p += WARPS) {
        const int ty = p / TW;
        const int tx = p % TW;
        float acc[2];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          float sum[2];
#pragma unroll
          for (int ky = 0; ky < 3; ++ky) {
            const float2 z = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                s.z1 + ((ty + ky) * Z1_W + tx + kx) * RS + 2 * lane));
            const float t0 = __fmul_rn(wd[ky * 3 + kx][0], z.x);
            const float t1 = __fmul_rn(wd[ky * 3 + kx][1], z.y);
            sum[0] = ky ? __fadd_rn(sum[0], t0) : t0;
            sum[1] = ky ? __fadd_rn(sum[1], t1) : t1;
          }
          acc[0] = kx ? __fadd_rn(acc[0], sum[0]) : sum[0];
          acc[1] = kx ? __fadd_rn(acc[1], sum[1]) : sum[1];
        }
        *reinterpret_cast<uint32_t*>(s.zdw + p * RS + 2 * lane) =
            pack_bf16(round_bf16(acc[0]) + bd[0], round_bf16(acc[1]) + bd[1]);
      }
      __syncthreads();
    }

    // 4. conv2 (DW: the pointwise conv over zdw): warp -> tile rows 2*warp
    // and 2*warp+1, all WD channels
    float acc[2][WD / 8][4] = {};
    const int arow = lane % 16;        // ldmatrix row this lane addresses
    const int acol = (lane / 16) * 8;
    for (int tap = 0; tap < (DW ? 1 : 9); ++tap) {
      const int ky = tap / 3;
      const int kx = tap % 3;
#pragma unroll
      for (int k0 = 0; k0 < WD; k0 += 16) {
        uint32_t a[2][4];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int ty = 2 * warp + mi;
          if (DW) {
            ldmatrix_x4(a[mi], s.zdw + (ty * TW + arow) * RS + k0 + acol);
          } else {
            ldmatrix_x4(a[mi], s.z1 + ((ty + ky) * Z1_W + arow + kx) * RS + k0 + acol);
          }
        }
#pragma unroll
        for (int j = 0; j < WD / 8; j += 2) {
          uint32_t bf[4];
          const int q = lane / 8;
          ldmatrix_x4(bf, s.w2 + (tap * WD + (j + (q >> 1)) * 8 + lane % 8) * RS +
                              k0 + (q & 1) * 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][j], a[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][j + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }

    // 5. bias + ReLU in bf16, the f32 out conv (quad reduction over the
    // 64 channels), residual; lane t == 0 writes pixels g and g+8
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int gy = y0 + 2 * warp + mi;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float part[MAX_C] = {0.f, 0.f, 0.f};
#pragma unroll
        for (int j = 0; j < WD / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int o = j * 8 + 2 * t + e;
            const float z2 = fmaxf(
                round_bf16(round_bf16(acc[mi][j][2 * h + e]) + __bfloat162float(b2[o])),
                0.f);
#pragma unroll
            for (int c = 0; c < MAX_C; ++c) {
              if (c < C) part[c] = fmaf(z2, __ldg(w3 + o * C + c), part[c]);
            }
          }
        }
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          part[c] += __shfl_xor_sync(0xffffffffu, part[c], 1);
          part[c] += __shfl_xor_sync(0xffffffffu, part[c], 2);
        }
        const int gx = x0 + g + 8 * h;
        if (t == 0 && gy < H && gx < W) {
          const size_t off = (img + static_cast<size_t>(gy) * W + gx) * C;
          for (int c = 0; c < C; ++c) {
            out[off + c] = __float2bfloat16_rn(pred[off + c] + (part[c] + b3[c]));
          }
        }
      }
    }
  }
}

template <int WD, bool DW>
int launch(const float* pred, const Planes& planes, int nplanes, int C,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* wdw, const void* bdw, const void* w3, const void* b3,
           void* out, int B, int H, int W, cudaStream_t stream) {
  const size_t smem = smem_bytes<WD, DW>(nplanes);
  cudaError_t err = cudaFuncSetAttribute(
      refine_head_kernel<WD, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, refine_head_kernel<WD, DW>, THREADS, smem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long ntiles = static_cast<long long>(B) * ((H + 15) / 16) * ((W + 15) / 16);
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(ntiles < static_cast<long long>(sms) * per_sm
                                        ? ntiles
                                        : static_cast<long long>(sms) * per_sm);
  refine_head_kernel<WD, DW><<<grid, THREADS, smem, stream>>>(
      pred, planes, nplanes, C,
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(wdw), static_cast<const __nv_bfloat16*>(bdw),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// plane_f32: bit k set when plane k (0-based, after the prediction) is f32.
// wdw != nullptr selects the depthwise head (width 64), with wpw and bpw in
// the w2 and b2 slots.
extern "C" int refine_head_bf16(const void* pred, const void* plane0,
                                const void* plane1, const void* plane2,
                                const void* plane3, int plane_f32, int nplanes,
                                int C, const void* w1, const void* b1,
                                const void* w2, const void* b2, const void* wdw,
                                const void* bdw, const void* w3, const void* b3,
                                void* out, int B, int H, int W, int width,
                                void* stream) {
  const int nextra = C > 0 ? nplanes / C - 1 : 0;
  const bool dw = wdw != nullptr;
  if ((width != 64 && width != 16) || (dw && (width != 64 || bdw == nullptr)) || C < 1 ||
      C > MAX_C || nplanes % C != 0 ||
      nextra < 1 || nextra > MAX_EXTRA || nplanes > MAX_NPLANES || B < 1 ||
      H < 1 || W < 1 || (plane_f32 >> nextra) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes planes;
  planes.f32 = plane_f32;
  const void* given[MAX_EXTRA] = {plane0, plane1, plane2, plane3};
  for (int k = 0; k < MAX_EXTRA; ++k) {
    planes.p[k] = given[k];
    if (k < nextra && given[k] == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(pred);
  if (dw) {
    return launch<64, true>(p, planes, nplanes, C, w1, b1, w2, b2, wdw, bdw, w3, b3, out, B,
                            H, W, st);
  }
  if (width == 64) {
    return launch<64, false>(p, planes, nplanes, C, w1, b1, w2, b2, wdw, bdw, w3, b3, out, B,
                             H, W, st);
  }
  return launch<16, false>(p, planes, nplanes, C, w1, b1, w2, b2, wdw, bdw, w3, b3, out, B, H,
                           W, st);
}
