// Block-granular gather and scatter of the tile-compact sparse engine,
// float32 and bfloat16, for Hopper (sm_90a).
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
// moves about 0.6 GB through these two kernels in float32 (half that
// in bfloat16), about 0.2 ms at 3.35 TB/s.
// What the design does about it:
//   * in the stack, block ty + 1 directly follows block ty in memory, so
//     a window is ONE contiguous run of window_h * twp * C elements. The
//     gather is a memcpy per tile. Blocks take 16 KB spans of it.
//   * a scattered tile row is one contiguous run of tw * C elements in both
//     vals and the canvas. One block copies one tile row.
//   * copies move 16 bytes per thread where the run's length is a
//     multiple of 16 bytes and both base pointers are 16-byte aligned.
//     Otherwise (the C=1 mask planes of odd widths) they move one element
//     per thread: 4 bytes in float32, 2 in bfloat16.
//   * both dtypes are one template on the element's storage type; a copy
//     never reads the values, so the bfloat16 instance moves them as
//     16-bit words and is bit-exact.
//   * an idx row outside the grid gathers zeros and scatters nothing, so
//     no index can read or write out of bounds.
// TMA bulk copies (cp.async.bulk) are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SPAN_BYTES = 16384;  // bytes of a gather window per block

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Copies len elements from src to dst with this block's threads.
template <typename T>
__device__ __forceinline__ void copy_run(const T* __restrict__ src,
                                         T* __restrict__ dst, int len) {
  constexpr int V = 16 / sizeof(T);  // elements per 16-byte vector
  if (len % V == 0 && aligned16(src) && aligned16(dst)) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < len / V; i += THREADS) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < len; i += THREADS) dst[i] = src[i];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
band_gather_kernel(const T* __restrict__ stack, const int* __restrict__ idx,
                   T* __restrict__ out, int N, int nw, int nhp, int th,
                   int row, int window_h) {
  constexpr int SPAN = SPAN_BYTES / sizeof(T);
  const int k = blockIdx.x;
  const size_t len = (size_t)window_h * row;
  const size_t start = (size_t)blockIdx.y * SPAN;
  if (start >= len) return;
  const int span = (int)min((size_t)SPAN, len - start);
  T* dst = out + k * len + start;

  const int n = idx[3 * k], ty = idx[3 * k + 1], tx = idx[3 * k + 2];
  const int last_ty = window_h > th ? nhp - 2 : nhp - 1;
  if (n < 0 || n >= N || tx < 0 || tx >= nw || ty < 0 || ty > last_ty) {
    for (int i = threadIdx.x; i < span; i += THREADS) dst[i] = T(0);
    return;
  }
  const T* src = stack + (((size_t)n * nw + tx) * nhp + ty) * th * row + start;
  copy_run(src, dst, span);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
block_scatter_kernel(const T* __restrict__ vals, const int* __restrict__ idx,
                     T* __restrict__ out, int N, int nh, int nw, int th,
                     int tw, int C) {
  const int k = blockIdx.x;
  const int r = blockIdx.y;
  const int n = idx[3 * k], ty = idx[3 * k + 1], tx = idx[3 * k + 2];
  if (n < 0 || n >= N || ty < 0 || ty >= nh || tx < 0 || tx >= nw) return;
  const int len = tw * C;
  const T* src = vals + ((size_t)k * th + r) * len;
  T* dst = out + (((size_t)n * nh + ty) * th + r) * nw * len +
           (size_t)tx * len;
  copy_run(src, dst, len);
}

template <typename T>
int launch_gather(const void* stack, const int* idx, void* out, int K, int N,
                  int nw, int nhp, int th, int row, int window_h, int device,
                  void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  constexpr int SPAN = SPAN_BYTES / sizeof(T);
  const size_t spans = ((size_t)window_h * row + SPAN - 1) / SPAN;
  if (spans > 65535 || window_h > 2 * th) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, (unsigned)spans);
  band_gather_kernel<T><<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(stack), idx, static_cast<T*>(out), N, nw, nhp,
      th, row, window_h);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const void* vals, const int* idx, void* out, int K, int N,
                   int nh, int nw, int th, int tw, int C, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (th > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(K, th);
  block_scatter_kernel<T><<<grid, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), idx, static_cast<T*>(out), N, nh, nw, th,
      tw, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Each launches on `stream` of device `device` and returns
// cudaGetLastError() after the launch (0 on success). Tensors are
// contiguous: stack (N, nw, nhp, th, row) with row = twp * C, out
// (K, window_h, row); vals (K, th, tw, C), out (N, nh*th, nw*tw, C)
// zeroed by the caller; idx (K, 3) int32. The _f32 entries take float32
// data, the _bf16 entries bfloat16 (moved as 16-bit words).
int band_gather_f32(const void* stack, const int* idx, void* out, int K,
                    int N, int nw, int nhp, int th, int row, int window_h,
                    int device, void* stream) {
  return launch_gather<float>(stack, idx, out, K, N, nw, nhp, th, row,
                              window_h, device, stream);
}

int band_gather_bf16(const void* stack, const int* idx, void* out, int K,
                     int N, int nw, int nhp, int th, int row, int window_h,
                     int device, void* stream) {
  return launch_gather<uint16_t>(stack, idx, out, K, N, nw, nhp, th, row,
                                 window_h, device, stream);
}

int block_scatter_f32(const void* vals, const int* idx, void* out, int K,
                      int N, int nh, int nw, int th, int tw, int C,
                      int device, void* stream) {
  return launch_scatter<float>(vals, idx, out, K, N, nh, nw, th, tw, C,
                               device, stream);
}

int block_scatter_bf16(const void* vals, const int* idx, void* out, int K,
                       int N, int nh, int nw, int th, int tw, int C,
                       int device, void* stream) {
  return launch_scatter<uint16_t>(vals, idx, out, K, N, nh, nw, th, tw, C,
                                  device, stream);
}

const char* blockio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
