// Banded stereo warp, float32, for Hopper (sm_90a): forward and backward.
//
// Border-clamped bilinear warp of an NHWC image by a row-banded grid, the
// rectified-stereo reprojection of the KITTI training step. Per output
// pixel (n, h, j):
//
//   out[n,h,j,:] = (1 - wy) * lerp(src[n, lo, :, :], x)
//                +      wy  * lerp(src[n, hi, :, :], x)
//   lerp(r, x)   = (1 - wx) * r[x0] + wx * r[x1]
//
// with x0 = floor(x), x1 = min(x0 + 1, W - 1), wx = x - x0 per pixel, and
// per row y0 = floor(yr), wy = yr - y0, sel = clip(y0 - (h - 1), 0, 1),
// lo = clip(h - 1 + sel, 0, H - 1), hi = clip(h + sel, 0, H - 1). The caller
// passes x (N, H, W) and yr (N, H) already normalised and clipped to the
// image; floor() carries no gradient, so d/dx and d/dyr are the gradients
// of wx and wy.
//
// Replaces the TPU Pallas kernel K3 of wavelet_monodepth_tpu/ops/warp.py,
// grid_sample_border_banded (_banded_core: _fwd_kernel and _bwd_kernel).
// The TPU kernel builds a (W x W) one-hot interpolation matrix in VMEM and
// runs one MXU dot per row; on Hopper the direct 2-tap lerp is the natural
// form: 4 loads and a few FMAs per output value, no matrix.
//
// What bounds it on the H100: memory. Per launch at (12, 192, 640, 3) the
// forward moves src + x + out = 41 MB (about 12 us at 3.35 TB/s) for ~10
// flops per output value; the backward moves g + src + x + gx (+ gsrc when
// the image needs a gradient) = 47 (65) MB.
// What the design does about it:
//   * one block per (image, row); consecutive threads take consecutive
//     (column, channel) values, so out, g and gsrc move in coalesced rows,
//     and the two source rows a block reads stay in L1/L2;
//   * the backward has no global atomics: a block owns one SOURCE row,
//     walks the at most 3 output rows that can reach it (h - 1, h, h + 1),
//     accumulates their scatter in shared memory (x is not monotone in j
//     when disparity varies, so several outputs can land on one source
//     pixel; shared-memory atomics resolve that) and writes the row once;
//   * the gradients of x (per pixel) and yr (per row, a block reduction)
//     are computed by the block of the matching output row, in the same
//     launch; the source-row pass is skipped when the image needs no
//     gradient, as on the training path.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

struct RowTaps {
  int lo, hi;
  float wy;
};

__device__ __forceinline__ RowTaps row_taps(const float* __restrict__ yr,
                                            int n, int h, int H) {
  const float y = yr[n * H + h];
  const float y0 = floorf(y);
  const float sel = fminf(fmaxf(y0 - (float)(h - 1), 0.f), 1.f);
  const int s = (int)sel;
  RowTaps t;
  t.lo = min(max(h - 1 + s, 0), H - 1);
  t.hi = min(max(h + s, 0), H - 1);
  t.wy = y - y0;
  return t;
}

// Column taps of one output pixel; indices are clamped into the row so a
// coordinate outside [0, W - 1] (the caller clips, so only NaN) cannot
// read out of bounds.
__device__ __forceinline__ void col_taps(float x, int W, int& x0, int& x1,
                                         float& wx) {
  const float f = floorf(x);
  wx = x - f;
  x0 = min(max((int)f, 0), W - 1);
  x1 = min(x0 + 1, W - 1);
}

__global__ void __launch_bounds__(THREADS)
banded_warp_fwd_kernel(const float* __restrict__ src,
                       const float* __restrict__ x,
                       const float* __restrict__ yr, float* __restrict__ out,
                       int H, int W, int C) {
  const int row = blockIdx.x;  // n * H + h
  const int n = row / H, h = row - n * H;
  const RowTaps t = row_taps(yr, n, h, H);
  const size_t row_len = (size_t)W * C;
  const float* s_lo = src + ((size_t)n * H + t.lo) * row_len;
  const float* s_hi = src + ((size_t)n * H + t.hi) * row_len;
  const float* xr = x + (size_t)row * W;
  float* o = out + (size_t)row * row_len;
  for (int k = threadIdx.x; k < W * C; k += blockDim.x) {
    const int j = k / C, c = k - j * C;
    int x0, x1;
    float wx;
    col_taps(xr[j], W, x0, x1, wx);
    const float lo_v = (1.f - wx) * s_lo[x0 * C + c] + wx * s_lo[x1 * C + c];
    const float hi_v = (1.f - wx) * s_hi[x0 * C + c] + wx * s_hi[x1 * C + c];
    o[k] = (1.f - t.wy) * lo_v + t.wy * hi_v;
  }
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += red[w];
  return total;  // valid in thread 0
}

// Block (n, r): gsrc of source row r (when gsrc != nullptr) from output
// rows r - 1 .. r + 1, then gx of output row r and gyr[n, r].
__global__ void __launch_bounds__(THREADS)
banded_warp_bwd_kernel(const float* __restrict__ src,
                       const float* __restrict__ x,
                       const float* __restrict__ yr,
                       const float* __restrict__ g, float* __restrict__ gsrc,
                       float* __restrict__ gx, float* __restrict__ gyr, int H,
                       int W, int C) {
  extern __shared__ float acc[];  // W * C, only when gsrc != nullptr
  __shared__ float red[THREADS / 32];
  const int row = blockIdx.x;
  const int n = row / H, r = row - n * H;
  const size_t row_len = (size_t)W * C;

  if (gsrc != nullptr) {
    for (int k = threadIdx.x; k < W * C; k += blockDim.x) acc[k] = 0.f;
    __syncthreads();
    for (int h = max(r - 1, 0); h <= min(r + 1, H - 1); ++h) {
      const RowTaps t = row_taps(yr, n, h, H);
      // both taps may be this row (clamped at the top and bottom edges)
      const float wr = (t.lo == r ? 1.f - t.wy : 0.f) + (t.hi == r ? t.wy : 0.f);
      if (t.lo != r && t.hi != r) continue;  // uniform across the block
      const float* gr = g + ((size_t)n * H + h) * row_len;
      const float* xr = x + ((size_t)n * H + h) * W;
      for (int k = threadIdx.x; k < W * C; k += blockDim.x) {
        const int j = k / C, c = k - j * C;
        int x0, x1;
        float wx;
        col_taps(xr[j], W, x0, x1, wx);
        const float gv = wr * gr[k];
        atomicAdd(&acc[x0 * C + c], (1.f - wx) * gv);
        atomicAdd(&acc[x1 * C + c], wx * gv);
      }
    }
    __syncthreads();
    float* dst = gsrc + (size_t)row * row_len;
    for (int k = threadIdx.x; k < W * C; k += blockDim.x) dst[k] = acc[k];
  }

  const RowTaps t = row_taps(yr, n, r, H);
  const float* s_lo = src + ((size_t)n * H + t.lo) * row_len;
  const float* s_hi = src + ((size_t)n * H + t.hi) * row_len;
  const float* gr = g + (size_t)row * row_len;
  const float* xr = x + (size_t)row * W;
  float part = 0.f;
  for (int j = threadIdx.x; j < W; j += blockDim.x) {
    int x0, x1;
    float wx;
    col_taps(xr[j], W, x0, x1, wx);
    float sx = 0.f;
    for (int c = 0; c < C; ++c) {
      const float l0 = s_lo[x0 * C + c], l1 = s_lo[x1 * C + c];
      const float h0 = s_hi[x0 * C + c], h1 = s_hi[x1 * C + c];
      const float gv = gr[j * C + c];
      sx += gv * ((1.f - t.wy) * (l1 - l0) + t.wy * (h1 - h0));
      part += gv * (((1.f - wx) * h0 + wx * h1) - ((1.f - wx) * l0 + wx * l1));
    }
    gx[(size_t)row * W + j] = sx;
  }
  const float total = block_sum(part, red);
  if (threadIdx.x == 0) gyr[row] = total;
}

}  // namespace

extern "C" {

// Each entry launches on `stream` of device `device` and returns
// cudaGetLastError() after its launch (0 on success). All tensors are
// contiguous float32: src (N, H, W, C), x (N, H, W), yr (N, H),
// out / g / gsrc (N, H, W, C), gx (N, H, W), gyr (N, H). The caller
// guarantees N * H <= 2^31 - 1 and W * C * 4 bytes of shared memory
// available to a block (the backward with gsrc).
int banded_warp_fwd_f32(const float* src, const float* x, const float* yr,
                        float* out, int N, int H, int W, int C, int device,
                        void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  banded_warp_fwd_kernel<<<N * H, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(src, x, yr,
                                                                out, H, W, C);
  return (int)cudaGetLastError();
}

// gsrc may be null: then only gx and gyr are computed.
int banded_warp_bwd_f32(const float* src, const float* x, const float* yr,
                        const float* g, float* gsrc, float* gx, float* gyr,
                        int N, int H, int W, int C, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = gsrc != nullptr ? (size_t)W * C * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(banded_warp_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  banded_warp_bwd_kernel<<<N * H, THREADS, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      src, x, yr, g, gsrc, gx, gyr, H, W, C);
  return (int)cudaGetLastError();
}

const char* banded_warp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
