// Block-granular gather and scatter of the tile-compact sparse engine,
// float32 and bfloat16, for Hopper (sm_90a).
//
//   band_gather   out[k] = rows [0, window_h) of the two vertically
//                 adjacent th-row blocks (ty, ty + 1) of a W-halo-tiled
//                 stack (N, nw, nh+1, th, twp, C), at idx[k] = (n, ty, tx)
//   block_scatter out[n, ty*th + r, tx*tw + c, :] = vals[k, r, c, :] for
//                 idx[k] = (n, ty, tx), zeros on every tile no row names
//
// Replaces the two TPU Pallas kernels of
// wavelet_monodepth_tpu/ops/blockio.py:
//   K5 band_gather   (_band_kernel: two scalar-prefetched BlockSpecs view
//                     the stack at blocks ty and ty + 1, the body stitches
//                     the window)
//   K6 block_scatter (_scatter_kernel: a scalar-prefetched output
//                     BlockSpec streams each tile to its home in an
//                     aliased zeros operand)
// On the TPU the index maps drive the block DMAs. Here K5's blocks load
// their own idx row and compute their offsets; K6 inverts idx.
//
// What bounds them on the H100: memory, and nothing else. Both copy
// bytes: no arithmetic. At the serving path's B=16 shapes one forward
// moves about 0.6 GB through these two kernels in float32 (half that
// in bfloat16), about 0.2 ms at 3.35 TB/s.
// What the design does about it:
//   * in the stack, block ty + 1 directly follows block ty in memory, so
//     a window is ONE contiguous run of window_h * twp * C elements. The
//     gather is a memcpy per tile. Blocks take 16 KB spans of it.
//   * the scatter is bound by the tiles read once and the whole canvas
//     written once. It writes every canvas byte exactly once, zeros
//     included, so the canvas needs no zeroing pass of its own (the TPU
//     kernel's aliased zeros operand). Each block first inverts idx into
//     a (N, nh, nw) table in shared memory: the idx row of each tile, or
//     -1. Then persistent blocks walk the canvas as one flat run, each
//     thread one unit (16 bytes; see below) per step, neighbouring threads on
//     neighbouring units: a unit's tile row slice (n, y, tx) comes from
//     three divisions by multiply and shift, its source from the table.
//     Four units per thread are loaded before any is stored. Stores
//     stream (st.global.cs): nothing here reads the canvas again, so its
//     lines are the first to leave L2 and the tiles' lines stay
//     (tools/k6_variants.py times this against write-back stores).
//   * copies move 16 bytes per thread where the run's length is a
//     multiple of 16 bytes and both base pointers are 16-byte aligned.
//     Otherwise (the C=1 mask planes of odd widths) they move one element
//     per thread: 4 bytes in float32, 2 in bfloat16.
//   * both dtypes are one template on the element's storage type; a copy
//     never reads the values, so the bfloat16 instance moves them as
//     16-bit words and is bit-exact.
//   * an idx row outside the grid gathers zeros and scatters nothing, so
//     no index can read or write out of bounds. The scatter also counts
//     such rows, and rows that name a tile an earlier row named (the
//     larger row wins, in every block alike), in a device-side counter
//     the caller reads when it wants: checking costs no host sync.
// TMA bulk copies (cp.async.bulk) are later work.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int SPAN_BYTES = 16384;  // bytes of a gather window per block

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
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

// n / d for 0 <= n < 2^31 by a multiply-high, an add and a shift
// (Granlund and Montgomery); the magic m and shift s are set on the host.
struct FastDiv {
  unsigned d, m, s;
};

FastDiv fast_div(unsigned d) {  // 1 <= d <= 2^31
  unsigned s = 0;
  while ((1ull << s) < d) ++s;
  const uint64_t m = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return {d, static_cast<unsigned>(m), s};
}

__device__ __forceinline__ unsigned divide(const FastDiv& f, unsigned n) {
  return (__umulhi(n, f.m) + n) >> f.s;
}

template <typename U>
__device__ __forceinline__ U zero_unit() {
  return U(0);
}

template <>
__device__ __forceinline__ uint4 zero_unit<uint4>() {
  return make_uint4(0, 0, 0, 0);
}

constexpr int SCATTER_THREADS = 512;
constexpr int SCATTER_UNROLL = 4;  // units loaded per thread before a store

// The canvas (N, nh*th, nw*tw*C) as `total` units U, `len` units per tile
// row slice; vals (K, th, len) units.
template <typename U>
__global__ void __launch_bounds__(SCATTER_THREADS)
block_scatter_kernel(const U* __restrict__ vals, const int* __restrict__ idx,
                     U* __restrict__ out, int* __restrict__ faults, int K,
                     int N, int nh, int nw, unsigned total, FastDiv by_len,
                     FastDiv by_nw, FastDiv by_th) {
  extern __shared__ int inv[];  // (N, nh, nw): the tile's idx row, or -1
  const int tiles = N * nh * nw;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) inv[t] = -1;
  __syncthreads();
  int bad = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int n = idx[3 * k], ty = idx[3 * k + 1], tx = idx[3 * k + 2];
    if (n < 0 || n >= N || ty < 0 || ty >= nh || tx < 0 || tx >= nw) {
      ++bad;
    } else if (atomicMax(&inv[(n * nh + ty) * nw + tx], k) >= 0) {
      ++bad;  // a second row for this tile
    }
  }
  if (bad && blockIdx.x == 0) atomicAdd(faults, bad);
  __syncthreads();

  const unsigned len = by_len.d, th = by_th.d;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned base = blockIdx.x * blockDim.x + threadIdx.x; base < total;
       base += SCATTER_UNROLL * stride) {
    U v[SCATTER_UNROLL];
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const unsigned g = base + u * stride;
      v[u] = zero_unit<U>();
      if (g < total) {
        const unsigned s = divide(by_len, g);     // slice (n, y, tx)
        const unsigned q = divide(by_nw, s);      // canvas row (n, y)
        const unsigned tx = s - q * by_nw.d;
        const unsigned tr = divide(by_th, q);     // tile row n*nh + ty
        const int k = inv[tr * by_nw.d + tx];
        if (k >= 0) {
          v[u] = vals[((size_t)k * th + (q - tr * th)) * len + (g - s * len)];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SCATTER_UNROLL; ++u) {
      const unsigned g = base + u * stride;
      if (g < total) __stcs(&out[g], v[u]);
    }
  }
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

int max_scatter_tiles(int device) {
  int bytes = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes / (int)sizeof(int) : -(int)err;
}

template <typename U>
int launch_scatter_units(const void* vals, const int* idx, void* out,
                         int* faults, int K, int N, int nh, int nw, int th,
                         unsigned len, int device, cudaStream_t stream) {
  const size_t tiles = (size_t)N * nh * nw;
  const size_t total = tiles * th * len;
  const size_t smem = tiles * sizeof(int);
  auto kernel = block_scatter_kernel<U>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, SCATTER_THREADS, smem);
  }
  if (err != cudaSuccess) return (int)err;
  // as many blocks as fit at once, fewer where a unit per thread covers
  // the canvas: small canvases get short threads
  const size_t blocks = std::max<size_t>(
      1, std::min<size_t>((size_t)per_sm * sms,
                          (total + SCATTER_THREADS - 1) / SCATTER_THREADS));
  kernel<<<(unsigned)blocks, SCATTER_THREADS, smem, stream>>>(
      static_cast<const U*>(vals), idx, static_cast<U*>(out), faults, K, N,
      nh, nw, (unsigned)total, fast_div(len), fast_div((unsigned)nw),
      fast_div((unsigned)th));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_scatter(const void* vals, const int* idx, void* out, int* faults,
                   int K, int N, int nh, int nw, int th, int tw, int C,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t tiles = (size_t)N * nh * nw;
  const size_t total = tiles * th * tw * C;
  if (K < 0 || tiles == 0 || total == 0 || total >= (1ull << 31) ||
      (int64_t)tiles > (int64_t)max_scatter_tiles(device)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t run_bytes = (size_t)tw * C * sizeof(T);
  auto s = static_cast<cudaStream_t>(stream);
  if (run_bytes % 16 == 0 && aligned16(vals) && aligned16(out)) {
    return launch_scatter_units<uint4>(vals, idx, out, faults, K, N, nh, nw,
                                       th, (unsigned)(run_bytes / 16),
                                       device, s);
  }
  return launch_scatter_units<T>(vals, idx, out, faults, K, N, nh, nw, th,
                                 (unsigned)(tw * C), device, s);
}

}  // namespace

extern "C" {

// Each launches on `stream` of device `device` and returns
// cudaGetLastError() after the launch (0 on success). Tensors are
// contiguous: stack (N, nw, nhp, th, row) with row = twp * C, out
// (K, window_h, row); vals (K, th, tw, C), out (N, nh*th, nw*tw, C), every
// element of which the scatter writes; idx (K, 3) int32; faults one int32
// on the device, to which the scatter adds its idx rows outside the grid
// or naming a tile twice. The _f32 entries take float32 data, the _bf16
// entries bfloat16 (moved as 16-bit words).
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

int block_scatter_f32(const void* vals, const int* idx, void* out,
                      int* faults, int K, int N, int nh, int nw, int th,
                      int tw, int C, int device, void* stream) {
  return launch_scatter<float>(vals, idx, out, faults, K, N, nh, nw, th, tw,
                               C, device, stream);
}

int block_scatter_bf16(const void* vals, const int* idx, void* out,
                       int* faults, int K, int N, int nh, int nw, int th,
                       int tw, int C, int device, void* stream) {
  return launch_scatter<uint16_t>(vals, idx, out, faults, K, N, nh, nw, th,
                                  tw, C, device, stream);
}

// The most (n, ty, tx) tiles a scatter's grid may hold on `device`: its
// inverse table must fit a block's shared memory. Negative: a CUDA error.
int block_scatter_max_tiles(int device) { return max_scatter_tiles(device); }

const char* blockio_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
