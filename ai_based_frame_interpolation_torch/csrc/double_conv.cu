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
//   16 warps split the work 8 (m16 tile rows) x 2 (32 channels of a pass
//   each), 128 registers a thread: the loop is bound by latency, not by
//   the MMAs (with them taken out, 8 warps ran a level 0-6% faster), so
//   twice the warps of one block per SM hide what 8 could not.
//   Pixel rows in shared memory are padded by 16 bytes so the eight rows of
//   an 8x8 matrix fall in distinct banks.
// - The weights do not fit on chip at every level (down2's pair is 1.77 MB
//   in bf16). They are packed once per model as a stream of chunks of one
//   tap x up to 64 input channels x up to 64 output channels, each chunk
//   contiguous with its rows already padded for ldmatrix, in the order the
//   MMA loops read them. A ring of S stages in shared memory (picked from
//   what the level's tile buffers leave free: 2 to 12; 6-9 at the levels)
//   takes them: one thread fills a stage with one
//   cp.async.bulk (the copy engine, no registers) against the stage's
//   "full" mbarrier; each warp arrives on the stage's "empty" mbarrier
//   after its last ldmatrix of it, and the filling thread waits on that
//   (one chunk behind its own warp) before it refills the stage S chunks
//   ahead. No block-wide barrier sits in the K loop. A tile's chunks
//   (conv1's N passes, then conv2's) are one stream that does not drain at
//   pass, conv or tile boundaries: the next tile's first chunks arrive
//   while this tile's conv2 finishes. Stage and phase (chunk counter mod S,
//   and (counter / S) & 1) advance by increments, and a per-block table in
//   shared memory gives each chunk's offset and size: no division on the
//   way, as every warp waits on the filling thread's progress.
// - Where both convs' weights fit beside the tile buffers (inc: 46 + 83 KB
//   beside 79 KB), the block loads them once into a resident copy and
//   walks all its tiles with no weight traffic; the host decides from the
//   bytes, not from the level.
// - The halo load issues PF loads a thread before it stores any (the up
//   block's upsample reads four `low` pixels per piece).
// - Simple before fast: the halo load, the two convs and the stores do not
//   overlap, one block runs per SM, and each N pass reloads its A
//   fragments. wgmma fed from the ring, a producer warp, and a work split
//   that keeps every warp busy at 8-row tiles are the next steps.
//
// Layouts: x [B,H,W,c0] bf16 (the skip for the up block), low
// [B,H/2,W/2,c1] bf16, out [B,H,W,cout] bf16, all channels-last and
// contiguous, every channel count a multiple of 8. Weights as
// ops/dconv_fused.py:pack_dconv_weights builds them, with k0p, k1p, midp and
// coutp the channel counts rounded up to 16 (the padding is zeros): w1 over
// (tap, out, in) [9][midp][k0p + k1p] (skip channels, then up channels) and
// w2 over [9][coutp][midp], each as its chunk stream: for each N pass of
// nw <= 64 outputs, each tap, each K chunk of kw <= 64 inputs, nw rows of
// kw + 8 bf16 (the last 8 zero). b1 [midp], b2 [coutp], bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TW = 16;                 // output tile columns (one m16 tile row)
constexpr int HALO_W = TW + 4;         // input window: two stacked 3x3 convs
constexpr int Z1_W = TW + 2;           // conv1 window: one 3x3 halo
constexpr int WARPS_M = 8;             // warps over a conv's pixels (M)
constexpr int WARPS_N = 2;             // warps over an N pass's channels
constexpr int WARPS = WARPS_M * WARPS_N;
constexpr int THREADS = WARPS * 32;
constexpr int NC = 64;                 // output channels per N pass
constexpr int NJ = NC / WARPS_N / 8;   // n8 tiles of a warp in an N pass
constexpr int KC = 64;                 // input channels per weight chunk
constexpr int WRS = KC + 8;            // a full chunk's row stride (bf16)
constexpr int STAGE = NC * WRS;        // ring stage (bf16): the largest chunk
constexpr int MIN_STAGES = 4;          // the ring a 16-row tile must leave room for
constexpr int MAX_STAGES = 12;
constexpr int FLOOR_STAGES = 2;        // the least ring that works (wide 8-row tiles)
constexpr int MAX_RESIDENT = 64;       // chunks a resident copy may hold
constexpr int PF = 4;                  // halo pieces a thread loads before it stores
constexpr int MT1 = 3;                 // conv1 m16 tiles per warp row (21 at 16 rows)
constexpr int MT2 = 2;                 // conv2 m16 tiles per warp row (16 at 16 rows)
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
  int stages;                          // ring stages, or the chunks of a resident copy
  int resident;                        // both weight streams stay in shared memory
};

__host__ __device__ inline int ceil16(int c) { return (c + 15) / 16 * 16; }

// shared memory of the tile buffers: the input window and z1
__host__ __device__ inline size_t tile_bytes(int th, int kin, int midp) {
  return sizeof(__nv_bfloat16) *
         (static_cast<size_t>((th + 4) * HALO_W) * (kin + 8) +
          static_cast<size_t>((th + 2) * Z1_W) * (midp + 8));
}

// one conv's weight stream: n_total outputs over k_ch inputs
struct Stream {
  int n_total, k_ch;
  __host__ __device__ int kchunks() const { return (k_ch + KC - 1) / KC; }
  __host__ __device__ int row() const { return k_ch + 8 * kchunks(); }  // a tap's row, all K chunks
  __host__ __device__ int chunks() const { return (n_total + NC - 1) / NC * 9 * kchunks(); }
  __host__ __device__ size_t elems() const { return static_cast<size_t>(9) * n_total * row(); }
  // chunk q's offset (bf16) in the stream and its size
  __host__ __device__ void chunk(int q, size_t& off, int& n) const {
    const int per_pass = 9 * kchunks();
    const int p = q / per_pass;
    const int tap = (q % per_pass) / kchunks();
    const int j = q % kchunks();
    const int nw = n_total - p * NC < NC ? n_total - p * NC : NC;
    const int kw = k_ch - j * KC < KC ? k_ch - j * KC : KC;
    off = (static_cast<size_t>(p) * NC * 9 + static_cast<size_t>(tap) * nw) * row() +
          static_cast<size_t>(nw) * j * WRS;
    n = nw * (kw + 8);
  }
};

// shared memory before the tile buffers: the barriers (full and empty per
// stage) and the chunk table; then the tile buffers, then the ring or the
// resident copy
__host__ __device__ inline size_t head_bytes(int stages, int per_tile) {
  return (2 * sizeof(uint64_t) * stages + 8 * static_cast<size_t>(per_tile) + 15) / 16 * 16;
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// one bulk copy of `bytes` (a multiple of 16, both ends 16-byte aligned)
// from device memory into shared memory, completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// A weight chunk: its offset (bf16) in the blob of both streams (w1's, then
// w2's), which is also its place in a resident copy, and its size in bytes.
struct Chunk {
  uint32_t off, bytes;
};

// The weight feed: both convs' chunk streams (conv1's, then conv2's) as one
// stream per tile, consumed chunk after chunk by every warp. The consumer's
// stage and phase, and the filling thread's, advance by increments: no
// division on the way.
struct Feed {
  const __nv_bfloat16* w1;
  const __nv_bfloat16* w2;
  uint32_t w1_elems;
  const Chunk* table;                  // [per_tile], in shared memory
  int per_tile, stages;
  bool resident;
  uint64_t* full;
  uint64_t* empty;
  __nv_bfloat16* buf;
  long long total;                     // chunks this block consumes
  // consumer: chunk g of the stream, in `stage` at `phase`
  long long g;
  int stage;
  uint32_t phase;
  // filling thread: chunk h next, chunk fill_q of a tile, into fill_stage
  // on its round's parity fill_phase
  long long h;
  int fill_q, fill_stage;
  uint32_t fill_phase;

  __device__ void fill() {
    const Chunk c = table[fill_q];
    const __nv_bfloat16* src = c.off < w1_elems ? w1 + c.off : w2 + (c.off - w1_elems);
    bulk_load(resident ? buf + c.off : buf + static_cast<size_t>(fill_stage) * STAGE, src,
              static_cast<int>(c.bytes), full + fill_stage);
    ++h;
    if (++fill_q == per_tile) fill_q = 0;
    if (++fill_stage == stages) {
      fill_stage = 0;
      fill_phase ^= 1u;
    }
  }

  // the first fill (one thread): the ring's S chunks, or the resident copy
  __device__ void start() {
    const long long n = resident ? per_tile : (stages < total ? stages : total);
    while (h < n) fill();
  }

  // chunk q of the tile is about to be read: its stage's data, once landed
  __device__ const __nv_bfloat16* acquire(int q) const {
    if (!resident || g < stages) mbar_wait(full + stage, phase);
    return resident ? buf + table[q].off : buf + static_cast<size_t>(stage) * STAGE;
  }

  // this warp is done with the current chunk: release its stage; the
  // filling thread refills the stage of the chunk before it (chunk
  // g - 1 + S), once every warp has released it
  __device__ void release() {
    if (!resident) {
      __syncwarp();
      if (threadIdx.x % 32 == 0) mbar_arrive(empty + stage);
      if (threadIdx.x == 0 && g >= 1 && h < total) {
        mbar_wait(empty + fill_stage, fill_phase ^ 1u);
        fill();
      }
      __syncwarp();
    }
    ++g;
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

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
// B is the conv's chunk stream (st), chunk q0 on of the tile's, taken from
// the feed. Warps split M (WARPS_M rows of m16 tiles) and each N pass of up
// to NC channels (WARPS_N parts of NJ n8 tiles); epi(nc, nw, acc) takes
// this warp's sums.
template <int MT, class Epi>
__device__ __forceinline__ void conv_pass(const __nv_bfloat16* s_a, int a_rs, int a_w,
                                          int m_w, int m_n, const Stream& st, int q0,
                                          Feed& feed, Epi epi) {
  const int tid = threadIdx.x;
  const int warp_m = tid / 32 % WARPS_M;
  const int n0 = tid / 32 / WARPS_M * (NJ * 8);  // this warp's channels in a pass
  const int lane = tid % 32;
  const int mtiles = (m_n + 15) / 16;
  int abase[MT];                       // A window index of this lane's row
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int m = min((warp_m + WARPS_M * i) * 16 + (lane & 15), m_n - 1);
    abase[i] = (m / m_w) * a_w + m % m_w;
  }
  int q = q0;
  for (int nc = 0; nc < st.n_total; nc += NC) {
    const int nw = min(NC, st.n_total - nc);
    float acc[MT][NJ][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    for (int tap = 0; tap < 9; ++tap) {
     for (int kc = 0; kc < st.k_ch; kc += KC, ++q) {
      const int kw = min(KC, st.k_ch - kc);
      const int rs = kw + 8;           // the chunk's row stride (bf16)
      const int toff = (tap / 3) * a_w + tap % 3;
      const __nv_bfloat16* sw = feed.acquire(q);
      for (int kk = 0; kk < kw; kk += 16) {
        uint32_t bfr[NJ][2];
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          if (n0 + j * 8 < nw) {
            uint32_t r[4];
            const int qq = lane / 8;
            ldmatrix_x4(r, sw + (n0 + (j + (qq >> 1)) * 8 + lane % 8) * rs + kk + (qq & 1) * 8);
            bfr[j][0] = r[0];
            bfr[j][1] = r[1];
            bfr[j + 1][0] = r[2];
            bfr[j + 1][1] = r[3];
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (warp_m + WARPS_M * i < mtiles) {
            uint32_t af[4];
            ldmatrix_x4(af, s_a + (abase[i] + toff) * a_rs + kc + kk + (lane >> 4) * 8);
#pragma unroll
            for (int j = 0; j < NJ; ++j) {
              if (n0 + j * 8 < nw) mma_bf16(acc[i][j], af, bfr[j][0], bfr[j][1]);
            }
          }
        }
      }
      feed.release();
     }
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
  const Stream s1{a.midp, kin}, s2{a.coutp, a.midp};
  const int t1 = s1.chunks();
  const int per_tile = t1 + s2.chunks();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);
  Chunk* table = reinterpret_cast<Chunk*>(bars + 2 * a.stages);
  __nv_bfloat16* s_in =
      reinterpret_cast<__nv_bfloat16*>(smem_raw + head_bytes(a.stages, per_tile));
  __nv_bfloat16* s_z1 = s_in + halo_n * rsi;

  const int tid = threadIdx.x;
  const int warp_m = tid / 32 % WARPS_M;
  const int n0 = tid / 32 / WARPS_M * (NJ * 8);  // this warp's channels in a pass
  const int lane = tid % 32;
  const int g = lane / 4;              // mma groupID
  const int t = lane % 4;              // mma thread in group
  const int H = a.H, W = a.W;
  const int p0 = a.k0p / 8;
  const int pieces = p0 + a.k1p / 8;

  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + th - 1) / th;
  const int ntiles = a.B * tiles_y * tiles_x;

  for (int q = tid; q < per_tile; q += THREADS) {
    size_t off;
    int n;
    if (q < t1) {
      s1.chunk(q, off, n);
    } else {
      s2.chunk(q - t1, off, n);
      off += s1.elems();
    }
    table[q] = Chunk{static_cast<uint32_t>(off),
                     static_cast<uint32_t>(n * sizeof(__nv_bfloat16))};
  }
  Feed feed;
  feed.w1 = a.w1;
  feed.w2 = a.w2;
  feed.w1_elems = static_cast<uint32_t>(s1.elems());
  feed.table = table;
  feed.per_tile = per_tile;
  feed.stages = a.stages;
  feed.resident = a.resident != 0;
  feed.full = bars;
  feed.empty = bars + a.stages;
  feed.buf = s_z1 + z1_n * rsz;
  feed.total = static_cast<long long>((ntiles - 1 - static_cast<int>(blockIdx.x)) /
                                          static_cast<int>(gridDim.x) + 1) * per_tile;
  feed.g = 0;
  feed.stage = 0;
  feed.phase = 0;
  feed.h = 0;
  feed.fill_q = 0;
  feed.fill_stage = 0;
  feed.fill_phase = 0;
  if (tid == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(feed.full + i, 1);
      mbar_init(feed.empty + i, WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                     // the barriers and the table are set
  if (tid == 0) feed.start();

  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int b = tile / (tiles_y * tiles_x);
    const int rem = tile - b * tiles_y * tiles_x;
    const int y0 = rem / tiles_x * th;
    const int x0 = rem % tiles_x * TW;

    __syncthreads();                   // the previous tile is done with s_in and z1

    // 1. the input window, zero outside the image and in the padding; each
    // thread issues the loads of PF pieces before it stores any
    const int nitems = halo_n * pieces;
    for (int base = tid; base < nitems; base += THREADS * PF) {
      uint4 v[PF];
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int idx = base + u * THREADS;
        const int p = idx / pieces;
        const int q = idx - p * pieces;
        const int gy = y0 - 2 + p / HALO_W;
        const int gx = x0 - 2 + p % HALO_W;
        v[u] = make_uint4(0u, 0u, 0u, 0u);
        if (idx < nitems && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          if (q < p0) {
            if (q * 8 < a.c0) {
              v[u] = __ldg(reinterpret_cast<const uint4*>(
                  a.x + ((static_cast<size_t>(b) * H + gy) * W + gx) * a.c0 + q * 8));
            }
          } else if ((q - p0) * 8 < a.c1) {
            v[u] = upsample8(a, b, gy, gx, (q - p0) * 8);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < PF; ++u) {
        const int idx = base + u * THREADS;
        if (idx < nitems) {
          const int p = idx / pieces;
          *reinterpret_cast<uint4*>(s_in + p * rsi + (idx - p * pieces) * 8) = v[u];
        }
      }
    }
    __syncthreads();                   // the window is in

    // 2. conv1 over the (th+2) x 18 window -> z1 in shared memory
    conv_pass<MT1>(s_in, rsi, HALO_W, Z1_W, z1_n, s1, 0, feed,
                   [&](int nc, int nw, float (&acc)[MT1][NJ][4]) {
#pragma unroll
      for (int i = 0; i < MT1; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (warp_m + WARPS_M * i) * 16 + g + 8 * h;
          if (m >= z1_n) continue;
          const int gy = y0 - 1 + m / Z1_W;
          const int gx = x0 - 1 + m % Z1_W;
          const bool inside = gy >= 0 && gy < H && gx >= 0 && gx < W;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (n0 + j * 8 >= nw) continue;
            const int o = nc + n0 + j * 8 + 2 * t;
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

    __syncthreads();                   // z1 is complete

    // 3. conv2 over the th x 16 tile -> the output
    conv_pass<MT2>(s_z1, rsz, Z1_W, TW, th * TW, s2, t1, feed,
                   [&](int nc, int nw, float (&acc)[MT2][NJ][4]) {
#pragma unroll
      for (int i = 0; i < MT2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = (warp_m + WARPS_M * i) * 16 + g + 8 * h;
          if (m >= th * TW) continue;
          const int gy = y0 + m / TW;
          const int gx = x0 + m % TW;
          if (gy >= H || gx >= W) continue;
          __nv_bfloat16* dst = a.out + ((static_cast<size_t>(b) * H + gy) * W + gx) * a.cout;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int o = nc + n0 + j * 8 + 2 * t;
            if (n0 + j * 8 >= nw || o >= a.cout) continue;
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

// The launch plan for a's channel counts: the tile height, then the largest
// ring that fits beside the tile buffers, or the resident copy of both
// weight streams where that fits. Sets a.th, a.stages, a.resident and
// returns the dynamic shared memory (above SMEM_LIMIT: nothing fits).
size_t plan(Args& a) {
  const int kin = a.k0p + a.k1p;
  const Stream s1{a.midp, kin}, s2{a.coutp, a.midp};
  const int per_tile = s1.chunks() + s2.chunks();
  const size_t stage_bytes = sizeof(__nv_bfloat16) * STAGE;
  const size_t blob = sizeof(__nv_bfloat16) * (s1.elems() + s2.elems());
  a.th = tile_bytes(16, kin, a.midp) + head_bytes(MIN_STAGES, per_tile) +
                     MIN_STAGES * stage_bytes <=
                 SMEM_LIMIT
             ? 16
             : 8;
  const size_t tiles = tile_bytes(a.th, kin, a.midp);
  if (per_tile <= MAX_RESIDENT &&
      tiles + head_bytes(per_tile, per_tile) + blob <= SMEM_LIMIT) {
    a.resident = 1;
    a.stages = per_tile;
    return tiles + head_bytes(per_tile, per_tile) + blob;
  }
  a.resident = 0;
  a.stages = MAX_STAGES;
  while (a.stages > FLOOR_STAGES &&
         tiles + head_bytes(a.stages, per_tile) + a.stages * stage_bytes > SMEM_LIMIT) {
    --a.stages;
  }
  return tiles + head_bytes(a.stages, per_tile) + a.stages * stage_bytes;
}

void set_channels(Args& a, int c0, int c1, int mid, int cout) {
  a.c0 = c0;
  a.c1 = c1;
  a.k0p = ceil16(c0);
  a.k1p = c1 ? ceil16(c1) : 0;
  a.midp = ceil16(mid);
  a.cout = cout;
  a.coutp = ceil16(cout);
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
  set_channels(a, c0, c1, mid, cout);
  const size_t smem = plan(a);
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

// The plan the kernel takes for these channel counts, for reports:
// out[0..3] = tile height, ring stages (or the resident copy's chunks),
// resident (0 or 1), weight chunks a tile streams. Returns 0, or
// cudaErrorInvalidValue where nothing fits shared memory.
extern "C" int double_conv_plan(int c0, int c1, int mid, int cout, int* out) {
  Args a;
  set_channels(a, c0, c1, mid, cout);
  const size_t smem = plan(a);
  const Stream s1{a.midp, a.k0p + a.k1p}, s2{a.coutp, a.midp};
  out[0] = a.th;
  out[1] = a.stages;
  out[2] = a.resident;
  out[3] = s1.chunks() + s2.chunks();
  return smem > SMEM_LIMIT ? static_cast<int>(cudaErrorInvalidValue) : 0;
}
