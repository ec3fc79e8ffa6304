// Block-granular gather and scatter of the tile-compact sparse engine,
// float32, for Hopper (sm_90a).
//
//   band_gather   out[k] = rows [0, window_h) of the two vertically
//                 adjacent th-row blocks (ty, ty + 1) of a W-halo-tiled
//                 stack (N, nw, nh+1, th, twp, C), at idx[k] = (n, ty, tx)
//   block_scatter out[n, ty*th + r, tx*tw + c, :] = vals[k, r, c, :] for
//                 idx[k] = (n, ty, tx); the caller zeroes the canvas
//
// Replaces the two TPU Pallas kernels of
// wavelet_monodepth_tpu/ops/blockio.py:
//   K5 band_gather   (_band_kernel: two scalar-prefetched BlockSpecs view
//                     the stack at blocks ty and ty + 1, the body stitches
//                     the window)
//   K6 block_scatter (_scatter_kernel: a scalar-prefetched output
//                     BlockSpec streams each tile to its home in an
//                     aliased zeros operand)
// On the TPU the index maps drive the block DMAs. Here each block loads
// its own idx row and computes its offsets.
//
// What bounds them on the H100: memory, and nothing else. Both copy
// bytes: no arithmetic. At the serving path's B=16 shapes one forward
// moves about 0.6 GB through these two kernels, about 0.2 ms at
// 3.35 TB/s.
// What the design does about it:
//   * in the stack, block ty + 1 directly follows block ty in memory, so
//     a window is ONE contiguous run of window_h * twp * C floats. The
//     gather is a memcpy per tile. Blocks take 4096-float spans of it.
//   * a scattered tile row is one contiguous run of tw * C floats in both
//     vals and the canvas. One block copies one tile row.
//   * copies move 16 bytes per thread where the run's length and both
//     offsets are multiples of 4 floats, with both base pointers 16-byte
//     aligned. Otherwise (the C=1 mask planes of odd widths) they move 4
//     bytes per thread.
//   * an idx row outside the grid gathers zeros and scatters nothing, so
//     no index can read or write out of bounds.
// TMA bulk copies (cp.async.bulk) are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SPAN = 4096;  // floats of a gather window per block

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies len floats from src to dst with this block's threads.
__device__ __forceinline__ void copy_run(const float* __restrict__ src,
                                         float* __restrict__ dst, int len) {
  if (len % 4 == 0 && aligned16(src) && aligned16(dst)) {
    const float4* s = reinterpret_cast<const float4*>(src);
    float4* d = reinterpret_cast<float4*>(dst);
    for (int i = threadIdx.x; i < len / 4; i += THREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < len; i += THREADS) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(THREADS)
band_gather_kernel(const float* __restrict__ stack,
                   const int* __restrict__ idx, float* __restrict__ out,
                   int N, int nw, int nhp, int th, int row, int window_h) {
  const int k = blockIdx.x;
  const size_t len = (size_t)window_h * row;
  const size_t start = (size_t)blockIdx.y * SPAN;
  if (start >= len) return;
  const int span = (int)min((size_t)SPAN, len - start);
  float* dst = out + k * len + start;

  const int n = idx[3 * k], ty = idx[3 * k + 1], tx = idx[3 * k + 2];
  const int last_ty = window_h > th ? nhp - 2 : nhp - 1;
  if (n < 0 || n >= N || tx < 0 || tx >= nw || ty < 0 || ty > last_ty) {
    for (int i = threadIdx.x; i < span; i += THREADS) dst[i] = 0.f;
    return;
  }
  const float* src =
      stack + (((size_t)n * nw + tx) * nhp + ty) * th * row + start;
  copy_run(src, dst, span);
}

__global__ void __launch_bounds__(THREADS)
block_scatter_kernel(const float* __restrict__ vals,
                     const int* __restrict__ idx, float* __restrict__ out,
                     int N, int nh, int nw, int th, int tw, int C) {
  const int k = blockIdx.x;
  const int r = blockIdx.y;
  const int n = idx[3 * k], ty = idx[3 * k + 1], tx = idx[3 * k + 2];
  if (n < 0 || n >= N || ty < 0 || ty >= nh || tx < 0 || tx >= nw) return;
  const int len = tw * C;
  const float* src = vals + ((size_t)k * th + r) * len;
  float* dst = out + (((size_t)n * nh + ty) * th + r) * nw * len +
               (size_t)tx * len;
  copy_run(src, dst, len);
}

}  // namespace

extern "C" {

// Each launches on `stream` of device `device` and returns
// cudaGetLastError() after the launch (0 on success). Tensors are
// contiguous: stack (N, nw, nhp, th, row) float32 with row = twp * C,
// out (K, window_h, row); vals (K, th, tw, C) float32, out (N, nh*th,
// nw*tw, C) zeroed by the caller; idx (K, 3) int32.
int band_gather_f32(const float* stack, const int* idx, float* out, int K,
                    int N, int nw, int nhp, int th, int row, int window_h,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t spans = ((size_t)window_h * row + SPAN - 1) / SPAN;
  if (spans > 65535 || window_h > 2 * th) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, (unsigned)spans);
  band_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      stack, idx, out, N, nw, nhp, th, row, window_h);
  return (int)cudaGetLastError();
}

int block_scatter_f32(const float* vals, const int* idx, float* out, int K,
                      int N, int nh, int nw, int th, int tw, int C,
                      int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (th > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, th);
  block_scatter_kernel<<<grid, THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      vals, idx, out, N, nh, nw, th, tw, C);
  return (int)cudaGetLastError();
}

const char* blockio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
