// Tile-sparse 3x3 convolution, float32, for Hopper (sm_90a).
//
// Computes  out = nonlin(conv3x3(pad(x), w) + b) * out_mask  on NHWC
// tensors, and skips every output granule whose activity flag is 0: such
// a granule is written as zeros without reading its input window or the
// weights.
//
// Replaces the two TPU Pallas kernels of
// wavelet_monodepth_tpu/ops/pallas_conv.py:
//   K1 conv3x3_tile_sparse     (_conv_kernel, one flag per image and
//                               8-row stripe)
//   K4 conv3x3_tile_sparse_2d  (_conv_kernel_2d, one flag per image and
//                               (8, 64) tile)
// One kernel serves both: the caller passes the flag granule (gth rows x
// gtw columns) and the flag grid (n_gh x n_gw per image).
//
// What bounds it on the H100: float32 FMAs on the CUDA cores for the
// active tiles (9 * Cin * Cout per output pixel; the tensor cores are not
// used, so the ceiling is the card's ~67 TFLOP/s of f32), plus reading
// each active tile's input window once per 32-channel slice of Cout.
// What the design does about it:
//   * a block owns an 8 x 64 output tile and up to 32 output channels;
//     each thread keeps an 8-row x 8-channel column of accumulators in
//     registers, so every input value read from shared memory feeds 24
//     FMAs and every weight value 8;
//   * the (8+2) x (64+2) halo window is staged in shared memory 8 input
//     channels at a time, laid out [channel][row][column] so a warp reads
//     32 consecutive columns without bank conflicts; staging moves 16
//     bytes (4 channels) per load and issues all of a thread's loads
//     before its stores, so the block waits about one load latency per
//     slice rather than one per element;
//   * reflect / replicate / zero padding is done by index arithmetic while
//     staging, so the padded copy the TPU caller materialises
//     (pallas_conv.py:165-176) never exists;
//   * flags are read once per block; inactive blocks only store zeros.
// Tensor cores (wgmma), TMA and double buffering are later work.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_H = 8;                 // output rows per block
constexpr int TILE_W = 64;                // output columns per block
constexpr int GROUPS = 4;                 // thread groups over out channels
constexpr int THREADS = TILE_W * GROUPS;  // one column per thread per group
constexpr int CK = 8;                     // input channels staged per pass
constexpr int WIN_H = TILE_H + 2;
constexpr int WIN_W = TILE_W + 2;

enum PadMode { PAD_ZERO = 0, PAD_REFLECT = 1, PAD_REPLICATE = 2 };
enum Nonlin {
  NL_NONE = 0, NL_ELU = 1, NL_SIGMOID = 2, NL_LEAKY01 = 3, NL_LEAKY02 = 4
};

// Source index along an axis of length n for window coordinate p, which
// lies in [-1, n + TILE]; -1 means the tap reads zero. Coordinates past
// the one-pixel halo only feed ragged outputs that are never stored.
__device__ __forceinline__ int src_index(int p, int n, int pad_mode) {
  if (p >= 0 && p < n) return p;
  if (p < -1 || p > n || pad_mode == PAD_ZERO) return -1;
  if (pad_mode == PAD_REFLECT) return p < 0 ? 1 : n - 2;
  return p < 0 ? 0 : n - 1;  // replicate
}

// The Pallas kernel's epilogue functions (pallas_conv.py:44-57): ELU as
// exp(x) - 1 and sigmoid as 1 / (1 + exp(-x)).
__device__ __forceinline__ float apply_nonlin(float y, int nonlin) {
  switch (nonlin) {
    case NL_ELU: return y > 0.f ? y : expf(y) - 1.f;
    case NL_SIGMOID: return 1.f / (1.f + expf(-y));
    case NL_LEAKY01: return y > 0.f ? y : 0.1f * y;
    case NL_LEAKY02: return y > 0.f ? y : 0.2f * y;
    default: return y;
  }
}

// CT output channels per thread; a block covers COB = 4 * CT of them.
template <int CT>
__global__ void __launch_bounds__(THREADS, 2)
tile_sparse_conv3x3_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           const int* __restrict__ flags,
                           float* __restrict__ out,
                           int H, int W, int Cin, int Cout, int n_th,
                           int pad_mode, int nonlin,
                           int gth, int gtw, int n_gh, int n_gw,
                           bool vec_x, bool vec_w) {
  constexpr int COB = CT * GROUPS;
  __shared__ float xs[CK][WIN_H][WIN_W];
  __shared__ __align__(16) float ws[9][CK][COB];

  const int tx = threadIdx.x % TILE_W;
  const int g = threadIdx.x / TILE_W;  // uniform within a warp
  const int n = blockIdx.y / n_th;
  const int h0 = (blockIdx.y % n_th) * TILE_H;
  const int w0 = blockIdx.x * TILE_W;
  const int co0 = blockIdx.z * COB;
  const int col = w0 + tx;
  const int cb = co0 + g * CT;  // this thread's first output channel

  const int flag = flags[(n * n_gh + h0 / gth) * n_gw + w0 / gtw];
  if (flag == 0) {
    if (col < W) {
      for (int r = 0; r < TILE_H && h0 + r < H; ++r) {
        float* o = out + ((size_t)(n * H + h0 + r) * W + col) * Cout;
#pragma unroll
        for (int j = 0; j < CT; ++j)
          if (cb + j < Cout) o[cb + j] = 0.f;
      }
    }
    return;
  }

  float acc[TILE_H][CT];
#pragma unroll
  for (int r = 0; r < TILE_H; ++r)
#pragma unroll
    for (int j = 0; j < CT; ++j) acc[r][j] = 0.f;

  const float* xn = x + (size_t)n * H * W * Cin;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    // Stage the halo window of channels [c0, c0 + CK). With vec_x each
    // thread moves 4 channels of one pixel per 16-byte load, and all its
    // loads are issued before the first store, so their latencies overlap.
    if (vec_x) {
      constexpr int NQ = WIN_H * WIN_W * (CK / 4);
      constexpr int QPT = (NQ + THREADS - 1) / THREADS;
      float4 buf[QPT];
#pragma unroll
      for (int it = 0; it < QPT; ++it) {
        const int e = threadIdx.x + it * THREADS;
        const int q = e % (CK / 4);
        const int pix = e / (CK / 4);
        const int sh = src_index(h0 - 1 + pix / WIN_W, H, pad_mode);
        const int sw = src_index(w0 - 1 + pix % WIN_W, W, pad_mode);
        buf[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < NQ && sh >= 0 && sw >= 0 && c0 + 4 * q < Cin)
          buf[it] = *reinterpret_cast<const float4*>(
              xn + ((size_t)sh * W + sw) * Cin + c0 + 4 * q);
      }
#pragma unroll
      for (int it = 0; it < QPT; ++it) {
        const int e = threadIdx.x + it * THREADS;
        if (e < NQ) {
          const int q = e % (CK / 4);
          const int pix = e / (CK / 4);
          const int r = pix / WIN_W, c = pix % WIN_W;
          xs[4 * q][r][c] = buf[it].x;
          xs[4 * q + 1][r][c] = buf[it].y;
          xs[4 * q + 2][r][c] = buf[it].z;
          xs[4 * q + 3][r][c] = buf[it].w;
        }
      }
    } else {
      for (int e = threadIdx.x; e < CK * WIN_H * WIN_W; e += THREADS) {
        const int ci = e % CK;
        const int pix = e / CK;
        const int c = pix % WIN_W;
        const int r = pix / WIN_W;
        const int sh = src_index(h0 - 1 + r, H, pad_mode);
        const int sw = src_index(w0 - 1 + c, W, pad_mode);
        float v = 0.f;
        if (sh >= 0 && sw >= 0 && c0 + ci < Cin)
          v = xn[((size_t)sh * W + sw) * Cin + c0 + ci];
        xs[ci][r][c] = v;
      }
    }
    // Weights (3, 3, Cin, Cout) HWIO -> ws[tap][ci][co], 16 bytes per load
    // when vec_w.
    if (CT % 4 == 0 && vec_w) {
      constexpr int NQ = 9 * CK * (COB / 4);
      constexpr int QPT = (NQ + THREADS - 1) / THREADS;
      float4 buf[QPT];
#pragma unroll
      for (int it = 0; it < QPT; ++it) {
        const int e = threadIdx.x + it * THREADS;
        const int co = 4 * (e % (COB / 4));
        const int ci = (e / (COB / 4)) % CK;
        const int k = e / ((COB / 4) * CK);
        buf[it] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < NQ && c0 + ci < Cin && co0 + co < Cout)
          buf[it] = *reinterpret_cast<const float4*>(
              w + ((size_t)k * Cin + c0 + ci) * Cout + co0 + co);
      }
#pragma unroll
      for (int it = 0; it < QPT; ++it) {
        const int e = threadIdx.x + it * THREADS;
        if (e < NQ) {
          const int co = 4 * (e % (COB / 4));
          const int ci = (e / (COB / 4)) % CK;
          const int k = e / ((COB / 4) * CK);
          *reinterpret_cast<float4*>(&ws[k][ci][co]) = buf[it];
        }
      }
    } else {
      for (int e = threadIdx.x; e < 9 * CK * COB; e += THREADS) {
        const int co = e % COB;
        const int ci = (e / COB) % CK;
        const int k = e / (COB * CK);
        float v = 0.f;
        if (c0 + ci < Cin && co0 + co < Cout)
          v = w[((size_t)k * Cin + c0 + ci) * Cout + co0 + co];
        ws[k][ci][co] = v;
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        float v[WIN_H];
#pragma unroll
        for (int r = 0; r < WIN_H; ++r) v[r] = xs[ci][r][tx + kx];
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          float wv[CT];
          const float* wp = &ws[ky * 3 + kx][ci][g * CT];
          if constexpr (CT % 4 == 0) {
#pragma unroll
            for (int q = 0; q < CT / 4; ++q) {
              const float4 t = reinterpret_cast<const float4*>(wp)[q];
              wv[4 * q] = t.x;
              wv[4 * q + 1] = t.y;
              wv[4 * q + 2] = t.z;
              wv[4 * q + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int j = 0; j < CT; ++j) wv[j] = wp[j];
          }
#pragma unroll
          for (int r = 0; r < TILE_H; ++r)
#pragma unroll
            for (int j = 0; j < CT; ++j)
              acc[r][j] = fmaf(v[r + ky], wv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  if (col >= W) return;
#pragma unroll
  for (int r = 0; r < TILE_H; ++r) {
    const int h = h0 + r;
    if (h >= H) break;
    const size_t pix = (size_t)(n * H + h) * W + col;
    const float m = mask[pix];
    float* o = out + pix * Cout;
#pragma unroll
    for (int j = 0; j < CT; ++j) {
      const int co = cb + j;
      if (co < Cout) o[co] = apply_nonlin(acc[r][j] + bias[co], nonlin) * m;
    }
  }
}

template <int CT>
void launch(const float* x, const float* w, const float* b, const float* mask,
            const int* flags, float* out, int N, int H, int W, int Cin,
            int Cout, int pad_mode, int nonlin, int gth, int gtw, int n_gh,
            int n_gw, cudaStream_t stream) {
  constexpr int COB = CT * GROUPS;
  const int n_th = (H + TILE_H - 1) / TILE_H;
  const dim3 grid((W + TILE_W - 1) / TILE_W, N * n_th,
                  (Cout + COB - 1) / COB);
  // 16-byte staging needs whole, aligned groups of 4 channels
  const bool vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  tile_sparse_conv3x3_kernel<CT><<<grid, THREADS, 0, stream>>>(
      x, w, b, mask, flags, out, H, W, Cin, Cout, n_th, pad_mode, nonlin,
      gth, gtw, n_gh, n_gw, vec_x, vec_w);
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launch (0 on success). All tensors are contiguous float32:
// x (N, H, W, Cin), w (3, 3, Cin, Cout), b (Cout), mask (N, H, W),
// out (N, H, W, Cout); flags int32 (N, n_gh, n_gw). The caller guarantees
// gth % 8 == 0 and (n_gw == 1 or gtw % 64 == 0), so each block lies in
// one flag granule, and N * ceil(H / 8) <= 65535.
int tile_sparse_conv3x3_f32(const float* x, const float* w, const float* b,
                            const float* mask, const int* flags, float* out,
                            int N, int H, int W, int Cin, int Cout,
                            int pad_mode, int nonlin, int gth, int gtw,
                            int n_gh, int n_gw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout >= 16)
    launch<8>(x, w, b, mask, flags, out, N, H, W, Cin, Cout, pad_mode,
              nonlin, gth, gtw, n_gh, n_gw, s);
  else
    launch<1>(x, w, b, mask, flags, out, N, H, W, Cin, Cout, pad_mode,
              nonlin, gth, gtw, n_gh, n_gw, s);
  return (int)cudaGetLastError();
}

const char* tile_sparse_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
