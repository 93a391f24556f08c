// skimage SSIM per image for Hopper (sm_90a).
//
// Replaces ops/pallas/ssim_fused.py of the JAX package: ssim_eval_fused
// (whole image in VMEM, body _ssim_kernel) and ssim_eval_tiled (64-row
// tiles with a 6-row halo, body _ssim_tiled_kernel). One kernel covers
// both, at every B, H, W >= 7 and every channel count. Per image, the mean
// over C * (H-6) * (W-6) valid positions of
//
//   sx, sy, sxx, syy, sxy = 7x7 window sums of x, y, x*x, y*y, x*y
//   ux = sx / 49,  uy = sy / 49
//   vx = (sxx - sx*ux) / 48, vy = (syy - sy*uy) / 48, vxy = (sxy - sx*uy) / 48
//   s  = ((2 ux uy + c1)(2 vxy + c2)) / ((ux^2 + uy^2 + c1)(vx + vy + c2))
//
// with c1 = (0.01 dr)^2, c2 = (0.03 dr)^2, in the Pallas kernel's f32
// expression order. The _rn intrinsics keep nvcc from contracting
// products and sums into FMAs, so each step rounds where the Pallas kernel
// rounds. For uint8 inputs the window sums are taken in int32: they are
// exact (at most 49 * 255^2 = 3,186,225 < 2^24), so they equal the Pallas
// kernel's f32 sums. For f32 inputs they are summed in the Pallas order:
// the 7 columns left to right, then the 7 row sums top to bottom.
//
// What bounds it on the H100: per valid position about 90 operations (3
// products, 5 x 12 window adds, about 25 for the algebra, 1 for the sum)
// against 2 bytes read (two uint8 images). At 8 x 1080 x 1920 gray that is
// about 1.5 GFLOP of f32 work (22 us at 67 TFLOP/s) against 33.2 MB
// (9.9 us at 3.35 TB/s): bound by operations.
//
// What the design does about it: one block per (image plane, 32x32 output
// tile) loads the tile and its 6-row, 6-column halo into shared memory
// once (each input byte is read from device memory about 1.4 times), takes
// the horizontal 7-sums of the five quantities into shared memory, then
// each thread takes the vertical 7-sums and the algebra for its outputs, so
// no intermediate map reaches device memory. The Pallas kernels' VMEM
// budgets (whole image up to ~720p, 64-row tiles, W <= 4096) have no
// counterpart: a tile is small and the grid covers any size.
//
// The reduction is deterministic: each block sums its values in a fixed
// order (per thread, then warp shuffles, then the 8 warps) to one f32
// partial; a second launch sums each image's partials in f64 in a fixed
// order and divides by the count. No float atomics, so the same inputs
// give the same bits on every run. An image smaller than the window has no
// valid position: only the second launch runs, and 0/0 gives NaN, as the
// JAX function's mean of nothing does.
//
// Layouts: x and y [B,H,W,C] are addressed by the element strides the
// caller passes (batch, row, column, channel), the same strides for both;
// partials f32 [B, C * tiles]; out f32 [B].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 7;
constexpr int TW = 32;                   // output tile: 32 columns
constexpr int TH = 32;                   //              x 32 rows
constexpr int IW = TW + WIN - 1;         // input tile with the halo
constexpr int IH = TH + WIN - 1;
constexpr int THREADS = 256;             // 32 x 8
constexpr int SUM_THREADS = 256;

// window sums: int32 for uint8 (exact), f32 for f32
template <typename T> struct Acc { using type = float; };
template <> struct Acc<uint8_t> { using type = int; };

__device__ __forceinline__ int load(const uint8_t* p) { return __ldg(p); }
__device__ __forceinline__ float load(const float* p) { return __ldg(p); }

__device__ __forceinline__ int mul(int a, int b) { return a * b; }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ int add(int a, int b) { return a + b; }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

struct Params {
  long long sb, sh, sw, sc;  // element strides of x and y
  int H, W, C, tiles_x, tiles;
  float c1, c2;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssim_tiles_kernel(const T* __restrict__ x, const T* __restrict__ y, Params p,
                  float* __restrict__ partials) {
  using A = typename Acc<T>::type;
  __shared__ A xs[IH][IW];
  __shared__ A ys[IH][IW];
  // horizontal 7-sums: sx, sy, sxx, syy, sxy
  __shared__ A hs[5][IH][TW];
  __shared__ float warp_sums[THREADS / 32];

  const int tile = blockIdx.x;
  const int plane = blockIdx.y;          // b * C + c
  const int b = plane / p.C, c = plane % p.C;
  const int x0 = (tile % p.tiles_x) * TW;
  const int y0 = (tile / p.tiles_x) * TH;
  const int tid = threadIdx.x;
  const long long base = b * p.sb + c * p.sc;

  for (int i = tid; i < IH * IW; i += THREADS) {
    const int r = i / IW, col = i % IW;
    const int gy = y0 + r, gx = x0 + col;
    A xv = 0, yv = 0;
    if (gy < p.H && gx < p.W) {
      const long long o = base + gy * p.sh + gx * p.sw;
      xv = load(x + o);
      yv = load(y + o);
    }
    xs[r][col] = xv;
    ys[r][col] = yv;
  }
  __syncthreads();

  for (int i = tid; i < IH * TW; i += THREADS) {
    const int r = i / TW, col = i % TW;
    A a = xs[r][col], bb = ys[r][col];
    A sx = a, sy = bb, sxx = mul(a, a), syy = mul(bb, bb), sxy = mul(a, bb);
#pragma unroll
    for (int d = 1; d < WIN; ++d) {
      a = xs[r][col + d];
      bb = ys[r][col + d];
      sx = add(sx, a);
      sy = add(sy, bb);
      sxx = add(sxx, mul(a, a));
      syy = add(syy, mul(bb, bb));
      sxy = add(sxy, mul(a, bb));
    }
    hs[0][r][col] = sx;
    hs[1][r][col] = sy;
    hs[2][r][col] = sxx;
    hs[3][r][col] = syy;
    hs[4][r][col] = sxy;
  }
  __syncthreads();

  const float n = static_cast<float>(WIN * WIN);
  const float cov_norm = static_cast<float>(1.0 / (WIN * WIN - 1.0));
  const int col = tid % TW;
  const int valid_w = p.W - WIN + 1, valid_h = p.H - WIN + 1;
  float acc = 0.f;
  if (x0 + col < valid_w) {
    for (int r = tid / TW; r < TH && y0 + r < valid_h; r += THREADS / TW) {
      A s[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) {
        A v = hs[k][r][col];
#pragma unroll
        for (int d = 1; d < WIN; ++d) v = add(v, hs[k][r + d][col]);
        s[k] = v;
      }
      const float sx = static_cast<float>(s[0]), sy = static_cast<float>(s[1]);
      const float sxx = static_cast<float>(s[2]), syy = static_cast<float>(s[3]);
      const float sxy = static_cast<float>(s[4]);
      const float ux = __fdiv_rn(sx, n);
      const float uy = __fdiv_rn(sy, n);
      const float vx = __fmul_rn(__fsub_rn(sxx, __fmul_rn(sx, ux)), cov_norm);
      const float vy = __fmul_rn(__fsub_rn(syy, __fmul_rn(sy, uy)), cov_norm);
      const float vxy = __fmul_rn(__fsub_rn(sxy, __fmul_rn(sx, uy)), cov_norm);
      const float num = __fmul_rn(
          __fadd_rn(__fmul_rn(__fmul_rn(2.f, ux), uy), p.c1),
          __fadd_rn(__fmul_rn(2.f, vxy), p.c2));
      const float den = __fmul_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)), p.c1),
          __fadd_rn(__fadd_rn(vx, vy), p.c2));
      acc = __fadd_rn(acc, __fdiv_rn(num, den));
    }
  }

  // fixed-order block sum: warp shuffles, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (tid % 32 == 0) warp_sums[tid / 32] = acc;
  __syncthreads();
  if (tid == 0) {
    float total = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) total = __fadd_rn(total, warp_sums[w]);
    partials[static_cast<long long>(b) * p.C * p.tiles +
             static_cast<long long>(c) * p.tiles + tile] = total;
  }
}

// one block per image: its partials summed in f64 in a fixed order
__global__ void __launch_bounds__(SUM_THREADS)
ssim_mean_kernel(const float* __restrict__ partials, int per_image,
                 double count, float* __restrict__ out) {
  __shared__ double sums[SUM_THREADS];
  const float* row = partials + static_cast<long long>(blockIdx.x) * per_image;
  double acc = 0.0;
  for (int i = threadIdx.x; i < per_image; i += SUM_THREADS) acc += row[i];
  sums[threadIdx.x] = acc;
  __syncthreads();
  for (int half = SUM_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(sums[0] / count);
}

}  // namespace

// Tiles per image plane of an H x W image (the partials buffer holds
// B * C * ssim_eval_tiles(H, W) floats); 0 when H or W < 7.
extern "C" int ssim_eval_tiles(int H, int W) {
  if (H < WIN || W < WIN) return 0;
  return ((W - WIN + 1 + TW - 1) / TW) * ((H - WIN + 1 + TH - 1) / TH);
}

// Returns 0 or a cudaError_t. Launches on `stream`, allocates nothing.
// strides: 4 element strides (batch, row, column, channel) of x and y.
// is_f32: x and y are f32, else uint8.
extern "C" int ssim_eval(const void* x, const void* y, const long long* strides,
                         int is_f32, void* partials, void* out, int B, int H,
                         int W, int C, float c1, float c2, void* stream) {
  if (B < 1 || H < 1 || W < 1 || C < 1 || static_cast<long long>(B) * C > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = ssim_eval_tiles(H, W);
  if (tiles > 0) {
    Params p;
    p.sb = strides[0];
    p.sh = strides[1];
    p.sw = strides[2];
    p.sc = strides[3];
    p.H = H;
    p.W = W;
    p.C = C;
    p.tiles_x = (W - WIN + 1 + TW - 1) / TW;
    p.tiles = tiles;
    p.c1 = c1;
    p.c2 = c2;
    const dim3 grid(tiles, B * C);
    if (is_f32) {
      ssim_tiles_kernel<float><<<grid, THREADS, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(y), p,
          static_cast<float*>(partials));
    } else {
      ssim_tiles_kernel<uint8_t><<<grid, THREADS, 0, st>>>(
          static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y), p,
          static_cast<float*>(partials));
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const double count = static_cast<double>(C) * (H - WIN + 1 > 0 ? H - WIN + 1 : 0) *
                       (W - WIN + 1 > 0 ? W - WIN + 1 : 0);
  ssim_mean_kernel<<<B, SUM_THREADS, 0, st>>>(static_cast<const float*>(partials),
                                              C * tiles, count,
                                              static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
