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
// forward moves src + x + yr + out = 41 MB (about 12 us at 3.35 TB/s) for
// ~10 flops per output value; the backward moves g + src + x + gx (+ gsrc
// when the image needs a gradient) = 47 (65) MB.
// What the forward's design does about it:
//   * one block per (image, band of R consecutive output rows). The
//     source rows the band can sample, h0 - 1 .. h0 + R clamped, are one
//     contiguous span of the NHWC image; the block stages it in shared
//     memory once with cp.async (16 bytes where W * C % 4 == 0 and src is
//     aligned), so each source row leaves HBM once and every gather hits
//     shared memory. The caller picks R from W * C so the band fits and
//     the grid fills the card in about one wave (ops/warp.py);
//   * a thread computes whole pixels: taps once per pixel, all C channels
//     from the staged rows. A warp takes 128 consecutive pixels of a row,
//     lane l the pixels l, l + 32, l + 64, l + 96, so x loads are
//     coalesced and the gathers of a warp fall on consecutive pixels (no
//     bank conflicts for odd C); the warp's 128 * C outputs go through a
//     per-warp shared buffer and leave as 16-byte stores (C floats per
//     lane per 4 pixels) where W * C % 4 == 0;
//   * row_taps / col_taps and the lerp order are the backward's and the
//     plain version's, so the result is theirs up to float rounding.
// And the backward's:
//   * one block per (image, row); consecutive threads take consecutive
//     (column, channel) values, so g and gsrc move in coalesced rows, and
//     the two source rows a block reads stay in L1/L2;
//   * no global atomics: a block owns one SOURCE row, walks the at most 3
//     output rows that can reach it (h - 1, h, h + 1), accumulates their
//     scatter in shared memory (x is not monotone in j when disparity
//     varies, so several outputs can land on one source pixel; shared-
//     memory atomics resolve that) and writes the row once;
//   * the gradients of x (per pixel) and yr (per row, a block reduction)
//     are computed by the block of the matching output row, in the same
//     launch; the source-row pass is skipped when the image needs no
//     gradient, as on the training path.

#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int FWD_CHUNK = 128;                 // pixels per warp item
constexpr int FWD_WARPS = THREADS / 32;

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Floats of shared memory a forward block takes: its band of up to R + 2
// source rows (rounded up to 16 bytes) and, for CT > 0, the warps' output
// buffers.
__host__ __device__ inline size_t fwd_smem_floats(int R, int W, int C,
                                                  int CT) {
  const size_t band = ((size_t)(R + 2) * W * C + 3) / 4 * 4;
  return band + (CT > 0 ? (size_t)FWD_WARPS * FWD_CHUNK * CT : 0);
}

// Block (n, band): output rows [h0, h0 + R) of image n. CT = C in 1..4
// (outputs staged per warp, 16-byte stores), or 0 for any C (one thread
// per pixel, scalar stores).
template <int CT>
__global__ void __launch_bounds__(THREADS)
banded_warp_fwd_kernel(const float* __restrict__ src,
                       const float* __restrict__ x,
                       const float* __restrict__ yr, float* __restrict__ out,
                       int H, int W, int C_rt, int R, bool vec) {
  extern __shared__ float4 smem4[];
  float* band = reinterpret_cast<float*>(smem4);
  const int C = CT > 0 ? CT : C_rt;
  const int bands = (H + R - 1) / R;
  const int n = blockIdx.x / bands;
  const int h0 = (blockIdx.x - n * bands) * R;
  const int h1 = min(h0 + R, H);
  const int r_lo = max(h0 - 1, 0), r_hi = min(h1, H - 1);
  const int row_len = W * C;

  // the band: source rows r_lo .. r_hi, one contiguous span
  const float* span = src + ((size_t)n * H + r_lo) * row_len;
  const int len = (r_hi - r_lo + 1) * row_len;
  if (vec) {
    for (int i = threadIdx.x; i < len / 4; i += THREADS)
      cp_async16(band + 4 * i, span + 4 * i);
  } else {
    for (int i = threadIdx.x; i < len; i += THREADS)
      cp_async4(band + i, span + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  if constexpr (CT == 0) {
    for (int p = threadIdx.x; p < (h1 - h0) * W; p += THREADS) {
      const int h = h0 + p / W, j = p % W;
      const RowTaps t = row_taps(yr, n, h, H);
      const float* b_lo = band + (size_t)(t.lo - r_lo) * row_len;
      const float* b_hi = band + (size_t)(t.hi - r_lo) * row_len;
      int x0, x1;
      float wx;
      col_taps(x[((size_t)n * H + h) * W + j], W, x0, x1, wx);
      float* o = out + (((size_t)n * H + h) * W + j) * C;
      for (int c = 0; c < C; ++c) {
        const float lo_v =
            (1.f - wx) * b_lo[x0 * C + c] + wx * b_lo[x1 * C + c];
        const float hi_v =
            (1.f - wx) * b_hi[x0 * C + c] + wx * b_hi[x1 * C + c];
        o[c] = (1.f - t.wy) * lo_v + t.wy * hi_v;
      }
    }
  } else {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    float* stage = band + fwd_smem_floats(R, W, C, 0) +
                   (size_t)warp * FWD_CHUNK * CT;
    const int per_row = (W + FWD_CHUNK - 1) / FWD_CHUNK;
    for (int item = warp; item < (h1 - h0) * per_row; item += FWD_WARPS) {
      const int h = h0 + item / per_row;
      const int j0 = (item % per_row) * FWD_CHUNK;
      const RowTaps t = row_taps(yr, n, h, H);
      const float* b_lo = band + (size_t)(t.lo - r_lo) * row_len;
      const float* b_hi = band + (size_t)(t.hi - r_lo) * row_len;
      const float* xr = x + ((size_t)n * H + h) * W;
#pragma unroll
      for (int k = 0; k < FWD_CHUNK / 32; ++k) {
        const int j = j0 + lane + 32 * k;
        if (j < W) {
          int x0, x1;
          float wx;
          col_taps(xr[j], W, x0, x1, wx);
#pragma unroll
          for (int c = 0; c < CT; ++c) {
            const float lo_v =
                (1.f - wx) * b_lo[x0 * CT + c] + wx * b_lo[x1 * CT + c];
            const float hi_v =
                (1.f - wx) * b_hi[x0 * CT + c] + wx * b_hi[x1 * CT + c];
            stage[(lane + 32 * k) * CT + c] =
                (1.f - t.wy) * lo_v + t.wy * hi_v;
          }
        }
      }
      __syncwarp();
      float* o = out + (((size_t)n * H + h) * W + j0) * CT;
      const int valid = min(FWD_CHUNK, W - j0) * CT;
      if (vec && valid == FWD_CHUNK * CT) {
#pragma unroll
        for (int q = 0; q < CT; ++q)
          reinterpret_cast<float4*>(o)[lane + 32 * q] =
              reinterpret_cast<const float4*>(stage)[lane + 32 * q];
      } else {
        for (int i = lane; i < valid; i += 32) o[i] = stage[i];
      }
      __syncwarp();  // the buffer is rewritten by the next item
    }
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

template <int CT>
cudaError_t launch_fwd(const float* src, const float* x, const float* yr,
                       float* out, int N, int H, int W, int C, int R,
                       void* stream) {
  const size_t smem = fwd_smem_floats(R, W, C, CT) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_warp_fwd_kernel<CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  // 16-byte band copies and stores need rows of whole, aligned float4s
  const bool vec = (W * C) % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const int bands = (H + R - 1) / R;
  banded_warp_fwd_kernel<CT><<<N * bands, THREADS, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      src, x, yr, out, H, W, C, R, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Each entry launches on `stream` of device `device` and returns the CUDA
// error code (0 on success). All tensors are contiguous float32: src
// (N, H, W, C), x (N, H, W), yr (N, H), out / g / gsrc (N, H, W, C),
// gx (N, H, W), gyr (N, H). The caller guarantees N * H <= 2^31 - 1,
// fwd_smem_floats(R, W, C, C <= 4 ? C : 0) * 4 bytes of shared memory for
// the forward's band of R rows, and W * C * 4 bytes for the backward with
// gsrc.
int banded_warp_fwd_f32(const float* src, const float* x, const float* yr,
                        float* out, int N, int H, int W, int C, int R,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (C) {
    case 1: err = launch_fwd<1>(src, x, yr, out, N, H, W, C, R, stream); break;
    case 2: err = launch_fwd<2>(src, x, yr, out, N, H, W, C, R, stream); break;
    case 3: err = launch_fwd<3>(src, x, yr, out, N, H, W, C, R, stream); break;
    case 4: err = launch_fwd<4>(src, x, yr, out, N, H, W, C, R, stream); break;
    default: err = launch_fwd<0>(src, x, yr, out, N, H, W, C, R, stream);
  }
  return (int)err;
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
