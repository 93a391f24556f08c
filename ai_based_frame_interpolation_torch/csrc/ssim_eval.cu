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
// exact (at most 49 * 255^2 = 3,186,225 < 2^23), so they equal the Pallas
// kernel's f32 sums, and each converts to f32 exactly. For f32 inputs they
// are summed in the Pallas order: the 7 columns left to right, then the 7
// row sums top to bottom.
//
// What bounds it on the H100: per valid position about 90 operations (3
// products, 5 x 12 window adds, about 25 for the algebra, 1 for the sum)
// against 2 bytes read (two uint8 images). At 8 x 1080 x 1920 gray that is
// about 1.5 GFLOP of f32 work (22 us at 67 TFLOP/s) against 33.2 MB
// (9.9 us at 3.35 TB/s): bound by operations. Three of them are IEEE
// divisions, each a reciprocal on the SM's 16-a-clock special-function
// unit and a correction.
//
// What the design does about it:
// - A block is one warp and owns a strip of 32 * CPT output columns
//   (CPT = 8 for uint8: 256 columns; 2 for f32) over a band of rows of
//   one image plane. The bands are sized per call so that the grid holds
//   about 16 blocks an SM (B * C * strips * bands), of an even number of
//   rows, 2 or more (each band reads 6 rows more than it outputs): 8 x 256
//   x 256 takes 1,000 blocks of 2 rows, 8 x 1080 x 1920 2,048 of 34.
// - The band's input rows stream through a 16-row shared ring, 8 rows
//   ahead, by 16-byte cp.async (16 uint8 pixels a copy) where a row's
//   address allows; rows that are not 16-byte aligned, or whose columns
//   are not contiguous (RGB), are copied element by element. One warp, so
//   a row costs one __syncwarp, not a block barrier.
// - uint8: each lane keeps int32 column sums of x, y, x*x, y*y and x*y over
//   the last 7 rows for its CPT + 6 columns, adding the row that enters and
//   subtracting the one that leaves (both in the ring), then slides the
//   horizontal 7-sums along its CPT outputs. Every window sum is exact, so
//   it equals the first port's. An int32 < 2^23 converts to f32 by an OR
//   and a subtraction (exact), not by the 16-a-clock conversion unit.
// - f32: each lane takes the horizontal 7-sums of its CPT outputs in the
//   Pallas order and keeps the last 7 rows of them in a register ring,
//   summed top to bottom for each output row.
// - The algebra is unchanged. A partial is one strip's sum over 2 output
//   rows: each lane sums its values in a fixed order (the rows top to
//   bottom, its columns left to right), the warp by shuffles in a fixed
//   tree, and lane 0 writes it. A second launch sums each image's
//   partials in f64 in a fixed order and divides by the count. So the
//   partials and the result do not depend on the bands: no float atomics,
//   and the same image pair gives the same bits on every run, on every
//   card and at every batch size. An image smaller than the window has no
//   valid position: only the second launch runs, and 0/0 gives NaN, as
//   the JAX function's mean of nothing does.
//
// Layouts: x and y [B,H,W,C] are addressed by the element strides the
// caller passes (batch, row, column, channel), the same strides for both;
// partials f32 [B, C * ssim_eval_tiles(H, W)] (the first C * strips *
// ceil((H - 6) / 2) of each image's row are written); out f32 [B].

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 7;
constexpr int LANES = 32;              // a block: one warp
constexpr int RING = 16;               // input rows in shared memory
// rows in flight: row i + AHEAD's copies must not reach the slot of row
// i - WIN, which leaves the window at row i (AHEAD < RING - WIN)
constexpr int AHEAD = RING - WIN - 1;
// a partial: one strip's sum over GROUP output rows (image rows GROUP * k
// to GROUP * k + GROUP - 1), whatever band computes it
constexpr int GROUP = 2;
constexpr int MIN_BAND = 2;            // output rows a band, at least; a multiple of GROUP
constexpr int BLOCKS_PER_SM = 16;      // resident blocks an SM (registers), the grid's target
constexpr int SUM_THREADS = 256;

template <typename T> struct Cols;     // output columns a lane
template <> struct Cols<uint8_t> { static constexpr int n = 8; };
template <> struct Cols<float> { static constexpr int n = 2; };

template <typename T> __host__ __device__ constexpr int strip_cols() { return LANES * Cols<T>::n; }
// bytes a staged row: the strip's columns and the window's 6 more, and
// the 16 bytes a lane's last load may reach past them
template <typename T> __host__ __device__ constexpr int row_cap() {
  return ((strip_cols<T>() + WIN - 1) * static_cast<int>(sizeof(T)) + 31) / 16 * 16;
}

// partials a strip of an image H high: one per GROUP output rows
__host__ __device__ __forceinline__ int groups_of(int H) {
  return (H - WIN + 1 + GROUP - 1) / GROUP;
}

struct Params {
  long long sb, sh, sw, sc;  // element strides of x and y
  int H, W, C, strips, bands, band_h;
  float c1, c2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Input row r of the strip from column x0 (n elements inside the image)
// into a ring row, lane by lane: 16-byte copies where the row starts on a
// 16-byte boundary and its columns are contiguous, else one element at a
// time.
template <typename T>
__device__ __forceinline__ void stage_row(T* dst, const T* src, long long sw, int n, int lane) {
  if (sw == 1 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int bytes = n * static_cast<int>(sizeof(T));
    const char* s = reinterpret_cast<const char*>(src);
    char* d = reinterpret_cast<char*>(dst);
    for (int j = lane * 16; j < bytes; j += LANES * 16) {
      if (j + 16 <= bytes) {
        cp_async16(d + j, s + j);
      } else {
        int k = j;
        for (; k + 4 <= bytes; k += 4) cp_async4(d + k, s + k);
        for (; k < bytes; ++k) d[k] = s[k];    // uint8 rows' last 1-3 bytes
      }
    }
  } else {
    for (int j = lane; j < n; j += LANES) dst[j] = src[j * sw];
  }
}

// v / 49 rounded to nearest for an integer v in [0, 49 * 255]: a product
// by RN(1/49) and one FMA correction give __fdiv_rn's result for every
// such v (tests/test_torch_ssim.py checks all 12,496), without the
// reciprocal unit and the range check of an IEEE division
__device__ __forceinline__ float div49(float v) {
  constexpr float r = 0x1.4e5e0ap-6f;              // RN(1/49)
  const float q = __fmul_rn(v, r);
  return __fmaf_rn(__fmaf_rn(-q, 49.f, v), r, q);
}

// s for one window from its five sums, in the Pallas kernel's order;
// EXACT_INT: the sums are the exact sums of uint8 images
template <bool EXACT_INT>
__device__ __forceinline__ float ssim_of(float sx, float sy, float sxx, float syy, float sxy,
                                         float c1, float c2) {
  const float n = static_cast<float>(WIN * WIN);
  const float cov_norm = static_cast<float>(1.0 / (WIN * WIN - 1.0));
  const float ux = EXACT_INT ? div49(sx) : __fdiv_rn(sx, n);
  const float uy = EXACT_INT ? div49(sy) : __fdiv_rn(sy, n);
  const float vx = __fmul_rn(__fsub_rn(sxx, __fmul_rn(sx, ux)), cov_norm);
  const float vy = __fmul_rn(__fsub_rn(syy, __fmul_rn(sy, uy)), cov_norm);
  const float vxy = __fmul_rn(__fsub_rn(sxy, __fmul_rn(sx, uy)), cov_norm);
  const float num = __fmul_rn(__fadd_rn(__fmul_rn(__fmul_rn(2.f, ux), uy), c1),
                              __fadd_rn(__fmul_rn(2.f, vxy), c2));
  const float den = __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy)), c1),
                              __fadd_rn(__fadd_rn(vx, vy), c2));
  return __fdiv_rn(num, den);
}

// an int32 in [0, 2^23) as f32, exactly
__device__ __forceinline__ float exact_float(int v) {
  return __fsub_rn(__int_as_float(0x4B000000 | v), 8388608.f);
}

__device__ __forceinline__ int byte_at(const uint32_t (&w)[4], int k) {
  return static_cast<int>(__byte_perm(w[k >> 2], 0, 0x4440 | (k & 3)));
}

// 16 bytes of a ring row at a uint8 lane's first column (8-byte aligned)
__device__ __forceinline__ void load16(const uint8_t* p, uint32_t (&w)[4]) {
  const uint2 a = *reinterpret_cast<const uint2*>(p);
  const uint2 b = *reinterpret_cast<const uint2*>(p + 8);
  w[0] = a.x;
  w[1] = a.y;
  w[2] = b.x;
  w[3] = b.y;
}

// The warp's sum of the lanes' acc by a fixed shuffle tree, written to
// *dst by lane 0; acc restarts at 0.
__device__ __forceinline__ void flush(float& acc, float* dst) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
  }
  if (threadIdx.x == 0) *dst = acc;
  acc = 0.f;
}

// One band of one strip of one image plane: a warp streams its input rows
// through the ring and writes the strip's partial of each GROUP output
// rows to out[group] (each lane sums its values in a fixed order).
template <typename T>
__device__ __forceinline__ void band_sum(const T* __restrict__ x, const T* __restrict__ y,
                                         const Params& p, long long base, int x0, int oy0,
                                         int rows_out, T* ring, float* __restrict__ out) {
  constexpr int CPT = Cols<T>::n;
  constexpr int CAP = row_cap<T>() / static_cast<int>(sizeof(T));   // elements a ring row
  const int lane = threadIdx.x;
  const int nin = rows_out + WIN - 1;
  const int n = min(strip_cols<T>() + WIN - 1, p.W - x0);
  const int valid_w = p.W - WIN + 1;
  const auto issue = [&](int i) {
    if (i < nin) {
      const long long o = base + static_cast<long long>(oy0 + i) * p.sh + x0 * p.sw;
      T* slot = ring + (i % RING) * 2 * CAP;
      stage_row(slot, x + o, p.sw, n, lane);
      stage_row(slot + CAP, y + o, p.sw, n, lane);
    }
    cp_async_commit();
  };
  for (int i = 0; i < AHEAD; ++i) issue(i);
  float acc = 0.f;
  const int c0 = lane * CPT;               // the lane's first column in the strip
  if constexpr (sizeof(T) == 1) {
    constexpr int NC = CPT + WIN - 1;
    int cx[NC], cy[NC], cxx[NC], cyy[NC], cxy[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) cx[k] = cy[k] = cxx[k] = cyy[k] = cxy[k] = 0;
    for (int i = 0; i < nin; ++i) {
      cp_async_wait<AHEAD - 1>();
      __syncwarp();
      issue(i + AHEAD);
      const uint8_t* in = reinterpret_cast<const uint8_t*>(ring + (i % RING) * 2 * CAP);
      uint32_t xw[4], yw[4];
      load16(in + c0, xw);
      load16(in + CAP + c0, yw);
#pragma unroll
      for (int k = 0; k < NC; ++k) {
        const int a = byte_at(xw, k), b = byte_at(yw, k);
        cx[k] += a;
        cy[k] += b;
        cxx[k] += a * a;
        cyy[k] += b * b;
        cxy[k] += a * b;
      }
      if (i >= WIN) {
        const uint8_t* out =
            reinterpret_cast<const uint8_t*>(ring + ((i - WIN) % RING) * 2 * CAP);
        load16(out + c0, xw);
        load16(out + CAP + c0, yw);
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const int a = byte_at(xw, k), b = byte_at(yw, k);
          cx[k] -= a;
          cy[k] -= b;
          cxx[k] -= a * a;
          cyy[k] -= b * b;
          cxy[k] -= a * b;
        }
      }
      if (i >= WIN - 1) {
        int sx = 0, sy = 0, sxx = 0, syy = 0, sxy = 0;
#pragma unroll
        for (int k = 0; k < WIN; ++k) {
          sx += cx[k];
          sy += cy[k];
          sxx += cxx[k];
          syy += cyy[k];
          sxy += cxy[k];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          if (j > 0) {
            sx += cx[j + WIN - 1] - cx[j - 1];
            sy += cy[j + WIN - 1] - cy[j - 1];
            sxx += cxx[j + WIN - 1] - cxx[j - 1];
            syy += cyy[j + WIN - 1] - cyy[j - 1];
            sxy += cxy[j + WIN - 1] - cxy[j - 1];
          }
          if (x0 + c0 + j < valid_w) {
            acc = __fadd_rn(acc, ssim_of<true>(exact_float(sx), exact_float(sy),
                                               exact_float(sxx), exact_float(syy),
                                               exact_float(sxy), p.c1, p.c2));
          }
        }
        const int row = oy0 + i - (WIN - 1);       // the output row just summed
        if ((row + 1) % GROUP == 0 || i == nin - 1) flush(acc, out + row / GROUP);
      }
    }
  } else {
    // the last 7 rows' horizontal sums: ring slot k holds rows i with i % 7 == k
    float h[WIN][5][CPT];
    for (int i0 = 0; i0 < nin; i0 += WIN) {
#pragma unroll
      for (int k = 0; k < WIN; ++k) {
        const int i = i0 + k;
        if (i >= nin) break;
        cp_async_wait<AHEAD - 1>();
        __syncwarp();
        issue(i + AHEAD);
        const float* in = reinterpret_cast<const float*>(ring + (i % RING) * 2 * CAP);
        float xv[CPT + WIN - 1], yv[CPT + WIN - 1];
#pragma unroll
        for (int d = 0; d < CPT + WIN - 1; ++d) {
          xv[d] = in[c0 + d];
          yv[d] = in[CAP + c0 + d];
        }
#pragma unroll
        for (int j = 0; j < CPT; ++j) {
          float a = xv[j], b = yv[j];
          float sx = a, sy = b, sxx = __fmul_rn(a, a), syy = __fmul_rn(b, b),
                sxy = __fmul_rn(a, b);
#pragma unroll
          for (int d = 1; d < WIN; ++d) {
            a = xv[j + d];
            b = yv[j + d];
            sx = __fadd_rn(sx, a);
            sy = __fadd_rn(sy, b);
            sxx = __fadd_rn(sxx, __fmul_rn(a, a));
            syy = __fadd_rn(syy, __fmul_rn(b, b));
            sxy = __fadd_rn(sxy, __fmul_rn(a, b));
          }
          h[k][0][j] = sx;
          h[k][1][j] = sy;
          h[k][2][j] = sxx;
          h[k][3][j] = syy;
          h[k][4][j] = sxy;
        }
        if (i >= WIN - 1) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) {
            float s[5];
#pragma unroll
            for (int q = 0; q < 5; ++q) {
              float v = h[(k + 1) % WIN][q][j];          // the top row, i - 6
#pragma unroll
              for (int d = 2; d <= WIN; ++d) v = __fadd_rn(v, h[(k + d) % WIN][q][j]);
              s[q] = v;
            }
            if (x0 + c0 + j < valid_w) {
              acc = __fadd_rn(acc, ssim_of<false>(s[0], s[1], s[2], s[3], s[4], p.c1, p.c2));
            }
          }
          const int row = oy0 + i - (WIN - 1);
          if ((row + 1) % GROUP == 0 || i == nin - 1) flush(acc, out + row / GROUP);
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(LANES, BLOCKS_PER_SM)
ssim_bands_kernel(const T* __restrict__ x, const T* __restrict__ y, Params p,
                  float* __restrict__ partials, int per_image_cap) {
  __shared__ __align__(16) T ring[RING * 2 * (row_cap<T>() / sizeof(T))];
  const int per_plane = p.strips * p.bands;
  const int plane = blockIdx.x / per_plane;       // b * C + c
  const int rem = blockIdx.x - plane * per_plane;
  const int strip = rem / p.bands;
  const int band = rem - strip * p.bands;
  const int b = plane / p.C, c = plane - (plane / p.C) * p.C;
  const int oy0 = band * p.band_h;
  const int rows_out = min(p.band_h, p.H - WIN + 1 - oy0);
  const long long base = b * p.sb + c * p.sc;
  float* out = partials + static_cast<long long>(b) * per_image_cap +
               (c * p.strips + strip) * groups_of(p.H);
  band_sum<T>(x, y, p, base, strip * strip_cols<T>(), oy0, rows_out, ring, out);
}

// one block per image: its partials summed in f64 in a fixed order
__global__ void __launch_bounds__(SUM_THREADS)
ssim_mean_kernel(const float* __restrict__ partials, int per_image, int stride,
                 double count, float* __restrict__ out) {
  __shared__ double sums[SUM_THREADS];
  const float* row = partials + static_cast<long long>(blockIdx.x) * stride;
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

// strips of an image W wide (the narrower uint8 strips of f32 count too)
int strips_of(int W, int cols) { return (W - WIN + 1 + cols - 1) / cols; }

// SMs of the current device, found once per device
constexpr int MAX_DEVICES = 64;

cudaError_t sm_count(int* sms) {
  static int known[MAX_DEVICES];       // 0: not yet known
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (known[device] == 0) {
    err = cudaDeviceGetAttribute(&known[device], cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
  }
  *sms = known[device];
  return cudaSuccess;
}

}  // namespace

// Partials per image plane of an H x W image (the partials buffer holds
// B * C * ssim_eval_tiles(H, W) floats): strips x row groups at the
// narrower f32 strips; 0 when H or W < 7.
extern "C" int ssim_eval_tiles(int H, int W) {
  if (H < WIN || W < WIN) return 0;
  return strips_of(W, strip_cols<float>()) * groups_of(H);
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
  const int cap = ssim_eval_tiles(H, W);
  int per_image = 0;
  if (cap > 0) {
    int sms = 0;
    const cudaError_t serr = sm_count(&sms);
    if (serr != cudaSuccess) return static_cast<int>(serr);
    Params p;
    p.sb = strides[0];
    p.sh = strides[1];
    p.sw = strides[2];
    p.sc = strides[3];
    p.H = H;
    p.W = W;
    p.C = C;
    p.strips = strips_of(W, is_f32 ? strip_cols<float>() : strip_cols<uint8_t>());
    p.c1 = c1;
    p.c2 = c2;
    // bands: about BLOCKS_PER_SM blocks an SM over the grid, of a multiple
    // of GROUP rows, MIN_BAND or more. They schedule the work only: the
    // partials are the same whatever the bands are.
    const int valid_h = H - WIN + 1;
    const long long planes = static_cast<long long>(B) * C * p.strips;
    const long long want = (static_cast<long long>(sms) * BLOCKS_PER_SM + planes - 1) / planes;
    const int bands = static_cast<int>(want < 1 ? 1 : (want > valid_h ? valid_h : want));
    const int rows = (valid_h + bands - 1) / bands;
    p.band_h = max(MIN_BAND, (rows + GROUP - 1) / GROUP * GROUP);
    p.bands = (valid_h + p.band_h - 1) / p.band_h;
    per_image = C * p.strips * groups_of(H);
    const long long blocks = planes * p.bands;
    if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    if (is_f32) {
      ssim_bands_kernel<float><<<static_cast<int>(blocks), LANES, 0, st>>>(
          static_cast<const float*>(x), static_cast<const float*>(y), p,
          static_cast<float*>(partials), C * cap);
    } else {
      ssim_bands_kernel<uint8_t><<<static_cast<int>(blocks), LANES, 0, st>>>(
          static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y), p,
          static_cast<float*>(partials), C * cap);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const double count = static_cast<double>(C) * (H - WIN + 1 > 0 ? H - WIN + 1 : 0) *
                       (W - WIN + 1 > 0 ? W - WIN + 1 : 0);
  ssim_mean_kernel<<<B, SUM_THREADS, 0, st>>>(static_cast<const float*>(partials), per_image,
                                              C * cap, count, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
