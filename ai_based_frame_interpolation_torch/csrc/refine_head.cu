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
// - Both activations stay on chip, as in the TPU kernel. The unit of work
//   is a 16x16 output tile: its 20x20 input halo, the 18x18xWD conv1
//   activation z1 (zero outside the image, which is conv2's SAME padding),
//   conv2, the bias/ReLU, the 1x1 out conv and the residual. Only the
//   planes are read and only the output is written.
// - Two tiles in flight per block. A block is 16 warps in two groups of
//   8; each group walks its own tiles and synchronises only its own warps
//   (named barriers 1 and 2: bar.sync id, 256), three times a tile. The
//   groups share the block's weights (the 9-tap w2, or the depthwise
//   head's 1x1 wpw; the conv1 weights; the epilogue's tables), loaded once
//   per block. A group that gets no tile (fewer tiles than groups) never
//   reaches a barrier of the other's. Where two groups' shared memory
//   does not fit (9 planes or more at WD=64) the launcher takes one group
//   of 8 warps; refine_head_variant reports which.
// - The halo is staged asynchronously a tile ahead. Each row of each plane
//   is one contiguous segment of an NHWC image row. One thread per (plane,
//   row) copies the segment's part inside the image, raw (f32 or bf16, as
//   given), into a staging row that keeps the source's address modulo 16:
//   its 16-byte aligned body by 16-byte cp.async, its ends (rows or
//   pointers that are not 16-byte aligned, the image edge) by 4-byte
//   cp.async, or 2-byte loads where a bf16 piece is not 4-byte aligned.
//   Nothing outside the image or the batch item is read. A tile starts by
//   converting its staged rows into the bf16 halo (zero outside the image;
//   the prediction and f32 planes round to bf16 here, once), a pixel's
//   planes together, and copying its f32 prediction aside for the
//   residual; then the next tile's copies are issued into the same staging
//   rows and land while this tile computes.
// - conv1 without gathers. The halo is pixel-major, the planes padded to
//   P, a multiple of 4 (zeros written once per block): each pixel is P
//   bf16, and a group of four K indices (a quad) of conv1's (tap, plane)
//   axis is 8 contiguous bytes. K is 9 * P padded to 16, and each lane's
//   four K values of an m16n8k16 A fragment row are one quad, one 8-byte
//   load at a halo offset from a per-block table; the conv1 weights are
//   laid out in shared memory in the matching order (once per block, from
//   the packed (out, tap, plane) w1), pad quads have zero weights and zero
//   operands. conv1 is compiled for each P (4, 8, 12, 16), its k loop
//   unrolled. Its 21 m16 tiles go to the group's warps whole (warps 0-4
//   take three, 5-7 two): a split of the last five tiles into n8 pieces,
//   one per warp in equal shares, was 3-5% slower on the H100 (each piece
//   another chain of dependent loads and MMAs).
// - conv2 runs on the tensor cores as an implicit GEMM with
//   mma.sync.m16n8k16 (bf16 in, f32 accumulate): M = 256 pixels, N = WD,
//   K = 9 taps x WD channels; each warp owns two tile rows (two m16 tiles)
//   and all WD output channels, so the out conv reduces within the warp
//   (quad shuffles). A and B fragments come from shared memory by
//   ldmatrix; z1, zdw and w2 rows are padded to WD + 8 bf16, so the eight
//   rows of each 8x8 matrix fall in distinct banks and every address is a
//   row base plus a constant.
// - At 16 warps an SM a thread has at most 128 registers and conv2 holds
//   64 accumulators; the thread's lane and warp ids are made opaque to the
//   compiler once per tile, so it computes addresses in the loop instead
//   of hoisting hundreds of them out of it and spilling them.
// - Bias + ReLU run on bf16 pairs (bf16(bf16(sum) + b), as before, one
//   rounding each). The epilogue reads each lane's fixed channels' b2 and
//   w3 (per channel pair, two float4 from a table built once per block;
//   held in registers across tiles they would spill at 128 registers),
//   reduces the out conv over the quad, adds the f32 prediction from
//   shared memory, and stages the warp's two output rows in shared memory;
//   the warp then writes them with 16-byte stores (2-byte pieces at
//   unaligned ends).
// - At WD=64 a block needs 204,512 bytes of shared memory at 3 planes, so
//   one block fills an SM (16 warps). At WD=16 it needs about 75 KB at 5
//   planes and the kernel is compiled for two blocks an SM (at most 64
//   registers a thread).
// - The depthwise instance (3 planes, 1088x1920) does 3,456 + 1,152 (f32,
//   on the CUDA cores) + 8,192 + 128 FLOP per pixel: 24.6 GFLOP on the
//   tensor cores (24.9 us) and 2.41 GFLOP of f32 (36.0 us at 67 TFLOP/s),
//   with the dense head's 20.9 MB of traffic. Its conv1 is the dense
//   head's. Each warp runs the depthwise 3x3 for its own two tile rows (the
//   rows its pointwise conv takes, so no barrier between them), two
//   channels per lane: a window slides along the 18 columns of four z1
//   rows, each z1 value read once, each column's three ky terms summed per
//   kx and added to its pixels in kx order. zdw goes to shared memory,
//   where the pointwise conv takes it as the A operand of one k=WD GEMM
//   per tile row.
// - Still far from the bound: conv2's mma.sync is fed by about 0.9 MB of
//   ldmatrix traffic per tile, and at 8 warps it runs at about half its
//   16-warp rate, so the groups overlap their other phases with each
//   other's conv2 only in part. wgmma is the next step.
//
// Layouts: pred [B,H,W,C] f32; planes [B,H,W,C] (up to 4), each bf16, or
// f32 where its bit in plane_f32 is set (the flow sampler's f32 warped
// frames go in as they are and round to bf16 in the halo conversion, as a
// cast would); any pointer aligned to its element. Concat channel p is
// (k = p / C, c = p % C) with k = 0 the prediction. w1 [WD][9*nplanes]
// bf16 (out, then tap-major, plane-minor), w2 [9][WD][WD] bf16 (tap, out,
// in; 16-byte aligned), b1/b2 [WD] bf16, w3 [WD][C] f32, b3 [C] f32.
// Output [B,H,W,C] bf16. The depthwise instance takes wpw [WD][WD] bf16
// (out, in) and bpw in place of w2 and b2, and wdw [9][WD] f32 (tap,
// channel) and bdw [WD] bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;                 // output tile rows
constexpr int TW = 16;                 // output tile columns (one m16 tile)
constexpr int HALO_W = TW + 4;         // input window (two stacked 3x3)
constexpr int HALO_H = TH + 4;
constexpr int HALO_N = HALO_H * HALO_W;
constexpr int Z1_W = TW + 2;           // conv1 window (one 3x3 halo)
constexpr int Z1_N = (TH + 2) * Z1_W;  // 324 pixels
constexpr int Z1_MT = (Z1_N + 15) / 16;
constexpr int GROUP_WARPS = 8;         // warps of one tile
constexpr int GROUP_THREADS = GROUP_WARPS * 32;
constexpr int MAX_GROUPS = 2;          // tiles in flight per block
constexpr int MAX_EXTRA = 4;           // planes besides the prediction
constexpr int MAX_K = 1 + MAX_EXTRA;   // staged planes
constexpr int MAX_C = 3;
constexpr int MAX_NPLANES = MAX_K * MAX_C;

static_assert(TH == 2 * GROUP_WARPS, "each warp owns two tile rows");
static_assert(Z1_MT <= 3 * GROUP_WARPS, "conv1: at most three m16 tiles a warp");

struct Planes {
  const void* p[MAX_EXTRA];
  int f32;                             // bit k - 1: plane k is f32
};

__host__ __device__ constexpr int up16(int n) { return (n + 15) / 16 * 16; }

// rows of conv2's weights in shared memory (the 1x1 wpw for DW)
template <int WD, bool DW>
__host__ __device__ constexpr int w2_rows() { return DW ? WD : 9 * WD; }

// bytes of a row of z1, zdw and w2 in shared memory: WD bf16 padded by 8,
// so the eight 16-byte rows of an ldmatrix 8x8 fall in distinct banks
// (word offsets 4i at WD=64, 12i at WD=16, mod 32) and every address is a
// row base plus a constant
template <int WD>
__host__ __device__ constexpr int row_bytes() { return 2 * (WD + 8); }

// element offset of channel k of row `row` in z1, zdw or w2
template <int WD>
__device__ __forceinline__ int zoff(int row, int k) { return row * (WD + 8) + k; }

// Where everything lies in shared memory, and the per-plane staging, for
// one (instance, planes, dtypes, groups); built on the host and passed by
// value. Byte offsets; w2 at 0.
struct Plan {
  int groups;
  int nk, C, nplanes;
  int P;                 // halo pixel stride (bf16): nplanes padded to 4
  int kp;                // conv1 K: 9 * P padded to 16
  int nq;                // real quads of K: 9 * P / 4
  int k1s;               // conv1 weight row in shared memory (bf16): kp + 8
  int elem[MAX_K];       // bytes per element of staged plane k (0: unused)
  int cap[MAX_K];        // staging row bytes of plane k
  int raw_off[MAX_K];    // plane k's staging rows in the group's raw area
  int ocap;              // output staging row bytes
  int w1, qoff, b1, epi, b3, src, wdw, group0, group_bytes;  // block-wide
  int z1, zdw, halo, raw, mis, predc, ostage;            // within a group
  int halo_bytes;        // a group's halo, zeroed once per block
  int smem;
};

template <int WD, bool DW>
Plan make_plan(int nplanes, int C, int plane_f32, int groups) {
  Plan L{};
  L.groups = groups;
  L.C = C;
  L.nplanes = nplanes;
  L.nk = nplanes / C;
  L.P = (nplanes + 3) / 4 * 4;
  L.kp = up16(9 * L.P);
  L.nq = 9 * L.P / 4;
  L.k1s = L.kp + 8;
  int raw = 0;
  for (int k = 0; k < MAX_K; ++k) {
    const int e = k >= L.nk ? 0 : (k == 0 || ((plane_f32 >> (k - 1)) & 1)) ? 4 : 2;
    L.elem[k] = e;
    // the segment's HALO_W * C elements and up to 15 bytes before them
    L.cap[k] = e ? up16(HALO_W * C * e + 15) : 0;
    L.raw_off[k] = raw;
    raw += HALO_H * L.cap[k];
  }
  L.ocap = up16(TW * C * 2 + 15);
  int off = w2_rows<WD, DW>() * row_bytes<WD>();
  L.w1 = off;
  off += WD * L.k1s * 2;
  L.qoff = off;
  off += up16(L.kp);                   // kp / 4 ints
  L.b1 = off;
  off += up16(WD * 2);
  L.epi = off;
  off += WD * 16;
  L.b3 = off;
  off += 16;
  L.src = off;
  off += up16(MAX_K * 24);
  L.wdw = off;                         // DW: taps [9][WD] f32, bias [WD] f32
  off += DW ? 10 * WD * 4 : 0;
  L.group0 = off;
  int g = 0;
  L.z1 = g;
  g += Z1_N * row_bytes<WD>();
  L.zdw = g;
  g += DW ? TH * TW * row_bytes<WD>() : 0;
  L.halo = g;
  L.halo_bytes = up16(HALO_N * L.P * 2);
  g += L.halo_bytes;
  L.raw = g;
  g += raw;
  L.mis = g;
  g += up16(MAX_K * HALO_H * 4);
  L.predc = g;
  g += TH * TW * C * 4;
  L.ostage = g;
  g += GROUP_WARPS * 2 * L.ocap;
  L.group_bytes = g;
  L.smem = off + groups * g;
  return L;
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void cp_async16(void* dst, uintptr_t src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, uintptr_t src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the warps of one group (named barrier 1 + group; 0 is __syncthreads)
__device__ __forceinline__ void group_sync(int gid) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + gid), "n"(GROUP_THREADS) : "memory");
}

// A staged plane: its source and its staging rows (a block-wide table)
struct PlaneSrc {
  unsigned long long base;  // data pointer
  int raw_off;              // byte offset of its rows in a group's raw area
  int cap;                  // bytes per staging row
  int elem;                 // bytes per element: 4 (f32) or 2 (bf16)
};
static_assert(sizeof(PlaneSrc) == 24, "Plan::src holds MAX_K * 24 bytes");

// A group's part of shared memory
struct Group {
  __nv_bfloat16* z1;    // [Z1_N] rows: conv1 activation
  __nv_bfloat16* zdw;   // [TH*TW] rows: DW: depthwise output
  uint16_t* halo;       // [HALO_N][P] bf16 bits, pixel-major
  unsigned char* raw;   // staged rows of the next tile, raw
  int* mis;             // [MAX_K][HALO_H] staging row start - 16-byte base
  float* predc;         // [TH*TW][C] the tile's f32 prediction
  unsigned char* ostage;  // this warp's two output rows
};

struct TileXY {
  int b, y0, x0;
};

__device__ __forceinline__ TileXY tile_xy(int tile, int tiles_x, int tiles_y) {
  TileXY p;
  p.b = tile / (tiles_y * tiles_x);
  const int rem = tile - p.b * tiles_y * tiles_x;
  p.y0 = rem / tiles_x * TH;
  p.x0 = rem % tiles_x * TW;
  return p;
}

// Global bytes [s, end) to staging at d + (s - a0), asynchronously: 4-byte
// copies where aligned, 2-byte loads for a bf16 piece that is not.
__device__ __forceinline__ void stage_piece(unsigned char* d, long long a0, long long s,
                                            long long end) {
  while (s < end) {
    if ((s & 3) == 0 && end - s >= 4) {
      cp_async4(d + (s - a0), static_cast<uintptr_t>(s));
      s += 4;
    } else {
      *reinterpret_cast<uint16_t*>(d + (s - a0)) =
          *reinterpret_cast<const uint16_t*>(static_cast<uintptr_t>(s));
      s += 2;
    }
  }
}

// Issue the copies of a tile's halo into the group's staging rows, one
// thread per (plane, row): the row's segment inside the image (nothing
// outside it or the batch item is read) lands at its address modulo 16,
// its 16-byte aligned body by 16-byte cp.async, its ends by stage_piece.
__device__ __forceinline__ void stage_halo(const Plan& L, const Group& G, const PlaneSrc* ps,
                                           TileXY p, int gt, int H, int W) {
  for (int idx = gt; idx < L.nk * HALO_H; idx += GROUP_THREADS) {
    const int k = idx / HALO_H;
    const int r = idx - k * HALO_H;
    const PlaneSrc s = ps[k];
    const int gy = p.y0 - 2 + r;
    const long long ce = static_cast<long long>(L.C) * s.elem;
    const long long base = static_cast<long long>(s.base);
    const long long row = (static_cast<long long>(p.b) * H + gy) * W;   // pixel (gy, 0)
    const long long g0 = base + (row + p.x0 - 2) * ce;                   // pixel (gy, x0 - 2)
    const long long a0 = g0 & ~15LL;
    G.mis[idx] = static_cast<int>(g0 - a0);
    if (gy < 0 || gy >= H) continue;
    long long lo = base + (row + max(p.x0 - 2, 0)) * ce;
    const long long hi = base + (row + min(p.x0 + TW + 2, W)) * ce;
    unsigned char* d = G.raw + s.raw_off + r * s.cap;
    const long long body = min((lo + 15) & ~15LL, hi);
    stage_piece(d, a0, lo, body);
    for (lo = body; lo + 16 <= hi; lo += 16) cp_async16(d + (lo - a0), static_cast<uintptr_t>(lo));
    stage_piece(d, a0, lo, hi);
  }
}

// The staged rows -> the bf16 halo (zero outside the image; the padded
// planes stay the zeros written once per block) and the f32 prediction of
// the tile's pixels; a thread takes a pixel's planes together.
__device__ __forceinline__ void convert_halo(const Plan& L, const Group& G, TileXY p, int gt,
                                             int H, int W) {
  const int C = L.C;
  for (int i = gt; i < HALO_N; i += GROUP_THREADS) {
    const int r = i / HALO_W;
    const int xx = i - r * HALO_W;
    const int gy = p.y0 - 2 + r;
    const int gx = p.x0 - 2 + xx;
    const bool valid = gy >= 0 && gy < H && gx >= 0 && gx < W;
    uint16_t* hp = G.halo + i * L.P;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k >= L.nk) break;
      const int e = L.elem[k];
      const unsigned char* src =
          G.raw + L.raw_off[k] + r * L.cap[k] + G.mis[k * HALO_H + r] + xx * C * e;
      if (e == 4) {
        const bool core = k == 0 && r >= 2 && r < 2 + TH && xx >= 2 && xx < 2 + TW;
        for (int c = 0; c < C; ++c) {
          const float v = valid ? reinterpret_cast<const float*>(src)[c] : 0.f;
          hp[k * C + c] = __bfloat16_as_ushort(__float2bfloat16_rn(v));
          if (core) G.predc[((r - 2) * TW + xx - 2) * C + c] = v;
        }
      } else {
        for (int c = 0; c < C; ++c) {
          hp[k * C + c] = valid ? reinterpret_cast<const uint16_t*>(src)[c] : 0;
        }
      }
    }
  }
}

// conv1 for m16 tile mt and all WD channels, with P planes a halo pixel:
// this lane's A quads (qo: halo offsets, -1 for pad quads) by one 8-byte
// load per fragment row and k step, B from w1s by ldmatrix; then bias and
// ReLU in bf16, zero outside the image, into z1.
template <int WD, int P>
__device__ __forceinline__ void conv1_tile(const Group& G, const __nv_bfloat16* w1s,
                                           const __nv_bfloat162* b1s,
                                           const int (&qo)[up16(9 * P) / 16], int mt, int lane,
                                           TileXY p, int H, int W) {
  constexpr int NT = WD / 8;
  constexpr int NKS = up16(9 * P) / 16;
  constexpr int K1S = up16(9 * P) + 8;
  const int g = lane >> 2;
  const int t = lane & 3;
  int hb[2];                           // halo element offset of rows g, g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + g + 8 * h;
    const int mm = m < Z1_N ? m : 0;
    hb[h] = ((mm / Z1_W) * HALO_W + mm % Z1_W) * P;
  }
  float acc[NT][4] = {};
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    // lane t's quad holds MMA k 2t, 2t+1 (low word) and 2t+8, 2t+9 (high)
    uint2 v[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
    if (qo[ks] >= 0) {
      v[0] = *reinterpret_cast<const uint2*>(G.halo + hb[0] + qo[ks]);
      v[1] = *reinterpret_cast<const uint2*>(G.halo + hb[1] + qo[ks]);
    }
    const uint32_t a[4] = {v[0].x, v[1].x, v[0].y, v[1].y};
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t bf[4];
      const int qm = lane / 8;
      ldmatrix_x4(bf, w1s + ((j + (qm >> 1)) * 8 + (lane & 7)) * K1S + ks * 16 + (qm & 1) * 8);
      mma_bf16(acc[j], a, bf[0], bf[1]);
      mma_bf16(acc[j + 1], a, bf[2], bf[3]);
    }
  }
  const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
  bool inside[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = mt * 16 + g + 8 * h;
    const int gy = p.y0 - 1 + m / Z1_W;
    const int gx = p.x0 - 1 + m % Z1_W;
    inside[h] = gy >= 0 && gy < H && gx >= 0 && gx < W;
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int o = j * 8 + 2 * t;
    const __nv_bfloat162 bb = b1s[o / 2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = mt * 16 + g + 8 * h;
      // bf16(bf16(sum) + b1), ReLU: one rounding per step, as in f32
      const __nv_bfloat162 v = __hmax2(
          __hadd2(__floats2bfloat162_rn(acc[j][2 * h], acc[j][2 * h + 1]), bb), zero2);
      if (m < Z1_N) *reinterpret_cast<__nv_bfloat162*>(G.z1 + zoff<WD>(m, o)) = inside[h] ? v : zero2;
    }
  }
}

// conv1 of a tile for one P: warp gw takes m16 tiles gw, gw + 8 and, for
// warps 0-4, gw + 16 (21 tiles; each warp's tiles whole, so its A quads
// serve all WD channels)
template <int WD, int P>
__device__ __forceinline__ void conv1(const Group& G, const __nv_bfloat16* w1s,
                                      const __nv_bfloat162* b1s, const int* qoff, int gw,
                                      int lane, TileXY p, int H, int W) {
  constexpr int NT = WD / 8;
  constexpr int NKS = up16(9 * P) / 16;
  int qo[NKS];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) qo[ks] = qoff[ks * 4 + (lane & 3)];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int mt = gw + i * GROUP_WARPS;
    if (mt < Z1_MT) conv1_tile<WD, P>(G, w1s, b1s, qo, mt, lane, p, H, W);
  }
}

// The warp's two staged output rows -> the image, 16-byte stores where
// both sides are aligned, 2-byte pieces at the ends.
__device__ __forceinline__ void store_rows(const Plan& L, const unsigned char* stage,
                                           __nv_bfloat16* out, TileXY p, int row0, int lane,
                                           int H, int W) {
  const int per_row = L.ocap >> 4;
  if (lane >= 2 * per_row) return;
  const int rr = lane / per_row;
  const int j = lane - rr * per_row;
  const int gy = row0 + rr;
  if (gy >= H) return;
  const long long px = (static_cast<long long>(p.b) * H + gy) * W + p.x0;
  const long long lo = static_cast<long long>(reinterpret_cast<uintptr_t>(out)) + px * L.C * 2;
  const long long hi = lo + static_cast<long long>(min(TW, W - p.x0)) * L.C * 2;
  const long long a0 = lo & ~15LL;
  const long long cs = a0 + 16 * j;
  long long s = max(lo, cs);
  const long long end = min(hi, cs + 16);
  const unsigned char* src = stage + rr * L.ocap + static_cast<int>(s - a0);
  if (end - s == 16) {
    *reinterpret_cast<uint4*>(static_cast<uintptr_t>(s)) = *reinterpret_cast<const uint4*>(src);
    return;
  }
  for (; s < end; s += 2, src += 2) {
    *reinterpret_cast<uint16_t*>(static_cast<uintptr_t>(s)) =
        *reinterpret_cast<const uint16_t*>(src);
  }
}

// compiled for one block of two groups per SM at WD=64 (shared memory
// allows no more; at most 128 registers a thread) and two at WD=16 (64)
template <int WD, bool DW>
__global__ void __launch_bounds__(MAX_GROUPS * GROUP_THREADS, WD == 16 ? 2 : 1)
refine_head_kernel(const float* __restrict__ pred, Planes planes, Plan L,
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
  constexpr int NT = WD / 8;           // n8 tiles
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* w2s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* w1s = reinterpret_cast<__nv_bfloat16*>(smem + L.w1);
  int* qoff = reinterpret_cast<int*>(smem + L.qoff);
  __nv_bfloat162* b1s = reinterpret_cast<__nv_bfloat162*>(smem + L.b1);
  float4* epi = reinterpret_cast<float4*>(smem + L.epi);
  float* b3s = reinterpret_cast<float*>(smem + L.b3);
  PlaneSrc* ps = reinterpret_cast<PlaneSrc*>(smem + L.src);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane0 = tid % 32;
  const int gid = warp / GROUP_WARPS;  // group
  const int gw0 = warp % GROUP_WARPS;  // warp in the group
  const int gt = tid % GROUP_THREADS;  // thread in the group
  const int C = L.C;

  unsigned char* gs = smem + L.group0 + gid * L.group_bytes;
  Group G;
  G.z1 = reinterpret_cast<__nv_bfloat16*>(gs + L.z1);
  G.zdw = reinterpret_cast<__nv_bfloat16*>(gs + L.zdw);
  G.halo = reinterpret_cast<uint16_t*>(gs + L.halo);
  G.raw = gs + L.raw;
  G.mis = reinterpret_cast<int*>(gs + L.mis);
  G.predc = reinterpret_cast<float*>(gs + L.predc);
  G.ostage = gs + L.ostage + gw0 * 2 * L.ocap;

  // block-wide tables: the planes' sources, conv1's quad offsets (-1: a
  // pad quad), b1, and per channel pair the epilogue's w3 and b2
  if (tid < MAX_K) {
    const void* src[MAX_K] = {pred, planes.p[0], planes.p[1], planes.p[2], planes.p[3]};
    PlaneSrc s;
    s.base = reinterpret_cast<unsigned long long>(src[tid]);
    s.raw_off = L.raw_off[tid];
    s.cap = L.cap[tid];
    s.elem = L.elem[tid];
    ps[tid] = s;
  }
  for (int q = tid; q < L.kp / 4; q += blockDim.x) {
    int off = -1;
    if (q < L.nq) {
      const int tap = 4 * q / L.P;
      off = ((tap / 3) * HALO_W + tap % 3) * L.P + 4 * q - tap * L.P;
    }
    qoff[q] = off;
  }
  for (int i = tid; i < WD / 2; i += blockDim.x) {
    const int o = 2 * i;
    b1s[i] = __halves2bfloat162(b1[o], b1[o + 1]);
    const __nv_bfloat162 bb = __halves2bfloat162(b2[o], b2[o + 1]);
    epi[2 * i] = make_float4(w3[o * C], C > 1 ? w3[o * C + 1] : 0.f,
                             C > 2 ? w3[o * C + 2] : 0.f,
                             __uint_as_float(*reinterpret_cast<const uint32_t*>(&bb)));
    epi[2 * i + 1] = make_float4(w3[(o + 1) * C], C > 1 ? w3[(o + 1) * C + 1] : 0.f,
                                 C > 2 ? w3[(o + 1) * C + 2] : 0.f, 0.f);
  }
  if (tid < MAX_C) b3s[tid] = tid < C ? b3[tid] : 0.f;
  // the halos' padded planes are zero for good
  for (int i = tid; i < L.groups * (L.halo_bytes / 4); i += blockDim.x) {
    const int gi = i / (L.halo_bytes / 4);
    reinterpret_cast<uint32_t*>(smem + L.group0 + gi * L.group_bytes + L.halo)
        [i - gi * (L.halo_bytes / 4)] = 0u;
  }
  // conv2's weights by 16-byte cp.async
  for (int idx = tid; idx < w2_rows<WD, DW>() * (WD / 8); idx += blockDim.x) {
    const int row = idx / (WD / 8);
    const int ch = idx % (WD / 8);
    cp_async16(w2s + zoff<WD>(row, ch * 8), reinterpret_cast<uintptr_t>(w2 + row * WD + ch * 8));
  }
  // conv1 weights in the halo's K order: column c of k step ks is the
  // lane-t quad element 4t + e (c = 2t + e) or 4t + 2 + e (c = 8 + 2t + e)
  // of K index ks * 16 + ..., i.e. (tap, plane) = divmod(K, P)
  for (int idx = tid; idx < WD * L.kp; idx += blockDim.x) {
    const int o = idx / L.kp;
    const int c = idx - o * L.kp;
    const int cc = c & 15;
    const int kk = (c & ~15) + 4 * ((cc & 7) >> 1) + ((cc >> 3) << 1) + (cc & 1);
    const int tap = kk / L.P;
    const int pl = kk - tap * L.P;
    w1s[o * L.k1s + c] = tap < 9 && pl < L.nplanes ? w1[o * 9 * L.nplanes + tap * L.nplanes + pl]
                                                   : __float2bfloat16_rn(0.f);
  }
  // DW: the depthwise taps and bias
  float* wdws = reinterpret_cast<float*>(smem + L.wdw);
  if (DW) {
    for (int i = tid; i < 10 * WD; i += blockDim.x) {
      wdws[i] = i < 9 * WD ? wdw[i] : __bfloat162float(bdw[i - 9 * WD]);
    }
  }
  __syncthreads();                     // the tables, before the first staging

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int ntiles = B * tiles_y * tiles_x;
  const int stride = gridDim.x * L.groups;
  int tile = blockIdx.x * L.groups + gid;
  if (tile < ntiles) stage_halo(L, G, ps, tile_xy(tile, tiles_x, tiles_y), gt, H, W);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  for (; tile < ntiles; tile += stride) {
    const TileXY p = tile_xy(tile, tiles_x, tiles_y);
    // the thread's ids, opaque to the compiler once per tile: addresses
    // derived from them are computed in the loop, not hoisted out of it
    // into registers the loop needs (and spilled)
    int lane = lane0, gw = gw0;
    asm volatile("" : "+r"(lane), "+r"(gw));
    const int g = lane / 4;            // mma groupID
    const int t = lane % 4;            // mma thread in group

    // 1. the staged rows -> bf16 halo; then the next tile's copies
    convert_halo(L, G, p, gt, H, W);
    group_sync(gid);
    if (tile + stride < ntiles) {
      stage_halo(L, G, ps, tile_xy(tile + stride, tiles_x, tiles_y), gt, H, W);
    }
    cp_async_commit();

    // 2. conv1, specialised for the halo's pixel stride
    switch (L.P) {
      case 4: conv1<WD, 4>(G, w1s, b1s, qoff, gw, lane, p, H, W); break;
      case 8: conv1<WD, 8>(G, w1s, b1s, qoff, gw, lane, p, H, W); break;
      case 12: conv1<WD, 12>(G, w1s, b1s, qoff, gw, lane, p, H, W); break;
      default: conv1<WD, 16>(G, w1s, b1s, qoff, gw, lane, p, H, W); break;
    }
    group_sync(gid);

    // 3. DW: the depthwise 3x3 in f32 for this warp's tile rows 2gw and
    // 2gw+1 (the rows its pointwise conv takes), channels 2*lane and
    // 2*lane+1: a window slid along the 18 columns of z1 rows 2gw..2gw+3,
    // each z1 value read once, each column's three ky terms summed per kx
    // and added to the pixels it belongs to in kx order
    if (DW) {
      float wd[9][2], bd[2];           // this lane's channel pair
#pragma unroll
      for (int tap = 0; tap < 10; ++tap) {
        const float2 w = *reinterpret_cast<const float2*>(wdws + tap * WD + 2 * lane);
        if (tap < 9) {
          wd[tap][0] = w.x;
          wd[tap][1] = w.y;
        } else {
          bd[0] = w.x;
          bd[1] = w.y;
        }
      }
      // per row o and channel: b = column sum kx=0 of pixel x-1, a = that
      // plus kx=1 of pixel x-2; column x completes pixel x-2
      float ra[2][2] = {}, rb[2][2] = {};
#pragma unroll
      for (int x = 0; x < Z1_W; ++x) {
        float2 z[4];
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          z[rr] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              G.z1 + zoff<WD>((2 * gw + rr) * Z1_W + x, 2 * lane)));
        }
#pragma unroll
        for (int o = 0; o < 2; ++o) {
          float cs[3][2];              // column x's ky sums for kx = 0, 1, 2
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
#pragma unroll
            for (int ch = 0; ch < 2; ++ch) {
              const float z0 = ch ? z[o].y : z[o].x;
              const float z1v = ch ? z[o + 1].y : z[o + 1].x;
              const float z2v = ch ? z[o + 2].y : z[o + 2].x;
              float sum = __fmul_rn(wd[kx][ch], z0);
              sum = __fadd_rn(sum, __fmul_rn(wd[3 + kx][ch], z1v));
              cs[kx][ch] = __fadd_rn(sum, __fmul_rn(wd[6 + kx][ch], z2v));
            }
          }
          if (x >= 2) {                // pixel x - 2: its kx = 2 term
            const float v0 = __fadd_rn(ra[o][0], cs[2][0]);
            const float v1 = __fadd_rn(ra[o][1], cs[2][1]);
            *reinterpret_cast<uint32_t*>(G.zdw + zoff<WD>((2 * gw + o) * TW + x - 2, 2 * lane)) =
                pack_bf16(round_bf16(v0) + bd[0], round_bf16(v1) + bd[1]);
          }
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            ra[o][ch] = __fadd_rn(rb[o][ch], cs[1][ch]);   // pixel x - 1
            rb[o][ch] = cs[0][ch];                         // pixel x
          }
        }
      }
      __syncwarp();
    }

    // 4. conv2 (DW: the pointwise conv over zdw): warp -> tile rows 2*gw
    // and 2*gw+1, all WD channels
    float acc[2][NT][4] = {};
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
          const int ty = 2 * gw + mi;
          if (DW) {
            ldmatrix_x4(a[mi], G.zdw + zoff<WD>(ty * TW + arow, k0 + acol));
          } else {
            ldmatrix_x4(a[mi], G.z1 + zoff<WD>((ty + ky) * Z1_W + arow + kx, k0 + acol));
          }
        }
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t bf[4];
          const int q = lane / 8;
          ldmatrix_x4(bf, w2s + zoff<WD>(tap * WD + (j + (q >> 1)) * 8 + lane % 8,
                                         k0 + (q & 1) * 8));
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) {
            mma_bf16(acc[mi][j], a[mi], bf[0], bf[1]);
            mma_bf16(acc[mi][j + 1], a[mi], bf[2], bf[3]);
          }
        }
      }
    }

    // 5. bias + ReLU in bf16 (a channel pair at a time), the f32 out conv
    // (quad reduction over the WD channels), residual with the staged f32
    // prediction; the warp's two rows staged, then stored
    float part[2][2][MAX_C] = {};
    const __nv_bfloat162 zero2 = __float2bfloat162_rn(0.f);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 q0 = epi[2 * (j * 4 + t)];       // w3[o][0..2], b2[o..o+1]
      const float4 q1 = epi[2 * (j * 4 + t) + 1];   // w3[o+1][0..2]
      const uint32_t bbits = __float_as_uint(q0.w);
      const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(&bbits);
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const __nv_bfloat162 v = __hmax2(
              __hadd2(__floats2bfloat162_rn(acc[mi][j][2 * h], acc[mi][j][2 * h + 1]), bb),
              zero2);
          const float z0 = __low2float(v);
          const float z1 = __high2float(v);
          part[mi][h][0] = fmaf(z0, q0.x, part[mi][h][0]);
          if (C > 1) {
            part[mi][h][1] = fmaf(z0, q0.y, part[mi][h][1]);
            part[mi][h][2] = fmaf(z0, q0.z, part[mi][h][2]);
          }
          part[mi][h][0] = fmaf(z1, q1.x, part[mi][h][0]);
          if (C > 1) {
            part[mi][h][1] = fmaf(z1, q1.y, part[mi][h][1]);
            part[mi][h][2] = fmaf(z1, q1.z, part[mi][h][2]);
          }
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int ty = 2 * gw + mi;
      const long long px0 = (static_cast<long long>(p.b) * H + p.y0 + ty) * W + p.x0;
      const int mis = static_cast<int>(
          (reinterpret_cast<uintptr_t>(out) + static_cast<uintptr_t>(px0 * C * 2)) & 15);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int c = 0; c < MAX_C; ++c) {
          part[mi][h][c] += __shfl_xor_sync(0xffffffffu, part[mi][h][c], 1);
          part[mi][h][c] += __shfl_xor_sync(0xffffffffu, part[mi][h][c], 2);
        }
        if (t < C) {                   // lane t writes channel t of pixel g + 8h
          const int tx = g + 8 * h;
          const float s = t == 0 ? part[mi][h][0] : (t == 1 ? part[mi][h][1] : part[mi][h][2]);
          const float v = G.predc[(ty * TW + tx) * C + t] + (s + b3s[t]);
          *reinterpret_cast<__nv_bfloat16*>(G.ostage + mi * L.ocap + mis + (tx * C + t) * 2) =
              __float2bfloat16_rn(v);
        }
      }
    }
    __syncwarp();
    store_rows(L, G.ostage, out, p, p.y0 + 2 * gw, lane, H, W);

    // 6. the next tile's halo has landed; the group is done with z1
    cp_async_wait_all();
    group_sync(gid);
  }
}

template <int WD, bool DW>
int configure(int nplanes, int C, int plane_f32, Plan* plan, int* per_sm) {
  int device = 0, optin = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return static_cast<int>(err);
  if ((err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                    device)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  // two groups where they fit, else one
  Plan L = make_plan<WD, DW>(nplanes, C, plane_f32, MAX_GROUPS);
  if (L.smem > optin) L = make_plan<WD, DW>(nplanes, C, plane_f32, 1);
  if (L.smem > optin) return static_cast<int>(cudaErrorInvalidConfiguration);
  if ((err = cudaFuncSetAttribute(refine_head_kernel<WD, DW>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, L.smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           per_sm, refine_head_kernel<WD, DW>, L.groups * GROUP_THREADS, L.smem)) !=
      cudaSuccess) {
    return static_cast<int>(err);
  }
  if (*per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  *plan = L;
  return 0;
}

template <int WD, bool DW>
int launch(const float* pred, const Planes& planes, int nplanes, int C,
           const void* w1, const void* b1, const void* w2, const void* b2,
           const void* wdw, const void* bdw, const void* w3, const void* b3,
           void* out, int B, int H, int W, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(w2) & 15) return static_cast<int>(cudaErrorMisalignedAddress);
  Plan L;
  int per_sm = 0;
  const int err = configure<WD, DW>(nplanes, C, planes.f32, &L, &per_sm);
  if (err) return err;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long ntiles = static_cast<long long>(B) * ((H + TH - 1) / TH) * ((W + TW - 1) / TW);
  if (ntiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long want = (ntiles + L.groups - 1) / L.groups;
  const long long fit = static_cast<long long>(sms) * per_sm;
  const int grid = static_cast<int>(want < fit ? want : fit);
  refine_head_kernel<WD, DW><<<grid, L.groups * GROUP_THREADS, L.smem, stream>>>(
      pred, planes, L,
      static_cast<const __nv_bfloat16*>(w1), static_cast<const __nv_bfloat16*>(b1),
      static_cast<const __nv_bfloat16*>(w2), static_cast<const __nv_bfloat16*>(b2),
      static_cast<const float*>(wdw), static_cast<const __nv_bfloat16*>(bdw),
      static_cast<const float*>(w3), static_cast<const float*>(b3),
      static_cast<__nv_bfloat16*>(out), B, H, W);
  return static_cast<int>(cudaGetLastError());
}

bool valid_shape(int nplanes, int C, int plane_f32, int width, bool dw) {
  const int nextra = C > 0 ? nplanes / C - 1 : 0;
  return (width == 64 || width == 16) && (!dw || width == 64) && C >= 1 && C <= MAX_C &&
         nplanes % C == 0 && nextra >= 1 && nextra <= MAX_EXTRA && nplanes <= MAX_NPLANES &&
         (plane_f32 >> nextra) == 0;
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
  const bool dw = wdw != nullptr;
  if (!valid_shape(nplanes, C, plane_f32, width, dw) || (dw && bdw == nullptr) || B < 1 ||
      H < 1 || W < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nextra = nplanes / C - 1;
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

// The variant refine_head_bf16 launches for these planes on the current
// device: variant[0] tiles in flight per block (groups), [1] dynamic
// shared memory per block in bytes, [2] blocks per SM. Returns 0 or a
// cudaError_t; launches nothing.
extern "C" int refine_head_variant(int nplanes, int C, int plane_f32, int width,
                                   int depthwise, int* variant) {
  if (!valid_shape(nplanes, C, plane_f32, width, depthwise != 0) || variant == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan L;
  int per_sm = 0;
  const int err = depthwise ? configure<64, true>(nplanes, C, plane_f32, &L, &per_sm)
                  : width == 64 ? configure<64, false>(nplanes, C, plane_f32, &L, &per_sm)
                                : configure<16, false>(nplanes, C, plane_f32, &L, &per_sm);
  if (err) return err;
  variant[0] = L.groups;
  variant[1] = L.smem;
  variant[2] = per_sm;
  return 0;
}
