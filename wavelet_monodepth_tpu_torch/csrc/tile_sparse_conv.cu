// Tile-sparse 3x3 convolution, float32 accuracy on Hopper's tensor cores
// (sm_90a), in 3xTF32.
//
// Computes  out = nonlin(conv3x3(pad(x), w) + b) * out_mask  on NHWC
// tensors, and skips every output granule of out_mask with no active
// pixel: such a granule is written as zeros without reading its input
// window or the weights.
//
// Replaces the two TPU Pallas kernels of
// wavelet_monodepth_tpu/ops/pallas_conv.py:
//   K1 conv3x3_tile_sparse     (_conv_kernel, one flag per image and
//                               8-row stripe)
//   K4 conv3x3_tile_sparse_2d  (_conv_kernel_2d, one flag per image and
//                               (8, 64) tile)
// One kernel serves both: the caller passes the flag granule (gth rows x
// gtw columns) and each block reduces its own granule of out_mask to the
// flag (any pixel > 0, as stripe_flags / tile_flags_2d do), so no flag
// tensor is built.
//
// What bounds it on the H100: per active output pixel 9 * Cin * Cout
// multiply-adds, and the bytes of the input pixels they read, the
// weights, the mask and the output. At float32 accuracy the fastest
// route for the operations is 3xTF32 (below), three TF32 products per
// multiply-add, so a third of the dense TF32 rate: 495 / 3 = 165 TFLOP/s,
// against 67 TFLOP/s of float32 FMAs on the CUDA cores. A tile kernel
// computes whole granules, at the decoder's 10% operating point 50-100%
// of the dense FLOPs, so its time is the tensor-core work of the active
// granules.
// What the design does about it:
//   * an implicit GEMM per block: M = an 8 x 64 output tile (8 warps, one
//     output row each, four m16 tiles), N = 32 output channels (NT = 4 n8
//     tiles) or, for Cout <= 8 (the wavelet heads, Cout = 3), one n8 tile,
//     K = 9 taps x Cin. The A operand of tap (ky, kx) is a shifted view of
//     the halo window in shared memory; no im2col exists;
//   * mma.sync.aligned.m16n8k8 TF32 with float32 accumulation, in 3xTF32:
//     each operand v is split into hi = tf32(v) (cvt.rna's rounding) and
//     lo = v - hi, and lo*hi + hi*lo + hi*hi is summed (lo*lo, ~2^-22 of
//     the product, is dropped). One TF32 product alone would be off by
//     ~1e-3 at these widths, over the 1e-4 contract; 3xTF32 stays near
//     float32 (tests/test_torch_port_tile_conv.py emulates it);
//   * the tensor cores round their float32 sums toward zero, so a large
//     accumulator fed three MMAs per k8 step drifts (1.8e-4 at Cin = 256
//     on the H100). Each tap's products (two k8 steps for 16 channels)
//     start from zero in a fresh fragment and join the running sum with
//     one rounded f32 add;
//   * the weights of a channel chunk are split into hi and lo once per
//     block, into shared memory; the window's A fragments are split as
//     they are loaded (four per m16 tile, reused over the NT n8 tiles);
//   * mma.sync and not wgmma: the nine A views are one-column offsets
//     into the window, natural for register fragments loaded from shared
//     memory and at odds with wgmma's swizzled K-major tiles;
//   * the (8+2) x (64+2) window and the weights of CK input channels are
//     staged with cp.async (16 bytes when Cin resp. Cout % 4 == 0 and the
//     pointer is aligned, else 4) into one of two buffers while the MMAs
//     consume the other; the window is channel-minor with a CK + 4 float
//     pixel stride and the weight rows are padded, so every fragment load
//     of a warp hits 32 distinct banks;
//   * reflect / replicate / zero padding is index arithmetic on the source
//     address while staging; zero padding and channels past Cin are the
//     copy's zero fill (src-size 0). The padded copy the TPU caller
//     materialises (pallas_conv.py:165-176) never exists;
//   * m16 tiles wholly right of W and rows below H issue no MMA;
//   * one linear grid over (image, row tile, column tile, channel block),
//     channel blocks innermost so the blocks that share a window run
//     together and find it in L2; no 65535 limit on N * ceil(H / 8).
// wgmma with A in registers and TMA-staged, swizzled weights, and a
// producer warp that stages while the others multiply, are later work
// (ROADMAP).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int TILE_H = 8;                 // output rows per block, 1 per warp
constexpr int TILE_W = 64;                // output columns per block
constexpr int THREADS = 32 * TILE_H;
constexpr int MT = TILE_W / 16;           // m16 tiles per warp
constexpr int WIN_H = TILE_H + 2;
constexpr int WIN_W = TILE_W + 2;

// NT n8 tiles of output channels per block; CK input channels per stage
// (KS k8 steps per tap); MINB blocks per SM (a register budget for
// ptxas). The window's pixel stride
// CKP % 8 == 4 and the weight rows' WP % 32 in {8, 24} make every
// fragment load of a warp hit 32 distinct banks. Shared memory: two
// cp.async stages (window + raw weights) and the current chunk's weights
// split into TF32 hi and lo.
template <int NT>
struct Cfg {
  static constexpr int NB = 8 * NT;
  static constexpr int CK = NT == 1 ? 8 : 16;
  static constexpr int KS = CK / 8;
  static constexpr int CKP = CK + 4;
  static constexpr int WP = NB % 16 == 8 ? NB : NB + 8;
  static constexpr int WIN = WIN_H * WIN_W * CKP;
  static constexpr int WTS = 9 * CK * WP;
  static constexpr int STAGE = WIN + WTS;
  static constexpr int SMEM_BYTES = (2 * STAGE + 2 * WTS) * 4;
  // NT = 4 takes ~216 registers; capped at 128 it spills and runs slower
  static constexpr int MINB = NT == 1 ? 2 : 1;
};

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

// cp.async of 16 or 4 bytes; ok == false zero-fills the destination
// (src-size 0) and reads nothing, so src only has to be a valid address.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: what cvt.rna.tf32.f32 computes, here as two
// integer operations), lo = v - hi exactly; the MMA reads lo's leading 10
// mantissa bits (TF32 operands ignore the low 13), so v is kept to
// ~2^-21 of itself.
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d = a (16x8, row) * b (8x8, col) [+ d] on the tensor cores, TF32 in,
// f32 out.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// Stages input channels [c0, c0 + CK) of the block's halo window into
// xs[WIN_H][WIN_W][CKP] and the matching raw weights, all 9 taps, into
// ws[9][CK][WP], asynchronously (one commit group per call).
template <int NT>
__device__ __forceinline__ void stage_chunk(
    float* xs, float* ws, const float* __restrict__ xn,
    const float* __restrict__ w, int h0, int w0, int c0, int co0, int H,
    int W, int Cin, int Cout, int pad_mode, bool vec_x, bool vec_w) {
  using C = Cfg<NT>;
  constexpr int CK = C::CK;
  if (vec_x) {
    constexpr int NQ = WIN_H * WIN_W * (CK / 4);
    for (int e = threadIdx.x; e < NQ; e += THREADS) {
      const int q = e % (CK / 4);
      const int pix = e / (CK / 4);
      const int r = pix / WIN_W, c = pix - r * WIN_W;
      const int sh = src_index(h0 - 1 + r, H, pad_mode);
      const int sw = src_index(w0 - 1 + c, W, pad_mode);
      const int ch = c0 + 4 * q;
      const bool ok = sh >= 0 && sw >= 0 && ch < Cin;
      cp_async16(xs + pix * C::CKP + 4 * q,
                 ok ? xn + ((size_t)sh * W + sw) * Cin + ch : xn, ok);
    }
  } else {
    for (int e = threadIdx.x; e < WIN_H * WIN_W * CK; e += THREADS) {
      const int ci = e % CK;
      const int pix = e / CK;
      const int r = pix / WIN_W, c = pix - r * WIN_W;
      const int sh = src_index(h0 - 1 + r, H, pad_mode);
      const int sw = src_index(w0 - 1 + c, W, pad_mode);
      const bool ok = sh >= 0 && sw >= 0 && c0 + ci < Cin;
      cp_async4(xs + pix * C::CKP + ci,
                ok ? xn + ((size_t)sh * W + sw) * Cin + c0 + ci : xn, ok);
    }
  }
  // weights (3, 3, Cin, Cout) HWIO -> ws[tap][ci][co]
  if (vec_w) {
    constexpr int NQ = 9 * CK * (C::NB / 4);
    for (int e = threadIdx.x; e < NQ; e += THREADS) {
      const int co = 4 * (e % (C::NB / 4));
      const int ci = (e / (C::NB / 4)) % CK;
      const int k = e / ((C::NB / 4) * CK);
      const bool ok = c0 + ci < Cin && co0 + co < Cout;
      cp_async16(ws + (k * CK + ci) * C::WP + co,
                 ok ? w + ((size_t)k * Cin + c0 + ci) * Cout + co0 + co : w,
                 ok);
    }
  } else {
    for (int e = threadIdx.x; e < 9 * CK * C::NB; e += THREADS) {
      const int co = e % C::NB;
      const int ci = (e / C::NB) % CK;
      const int k = e / (C::NB * CK);
      const bool ok = c0 + ci < Cin && co0 + co < Cout;
      cp_async4(ws + (k * CK + ci) * C::WP + co,
                ok ? w + ((size_t)k * Cin + c0 + ci) * Cout + co0 + co : w,
                ok);
    }
  }
  cp_async_commit();
}

template <int NT>
__global__ void __launch_bounds__(THREADS, Cfg<NT>::MINB)
tile_sparse_conv3x3_kernel(const float* __restrict__ x,
                           const float* __restrict__ w,
                           const float* __restrict__ bias,
                           const float* __restrict__ mask,
                           float* __restrict__ out, int H, int W, int Cin,
                           int Cout, int pad_mode, int nonlin, int gth,
                           int gtw, int n_th, int n_tw, int n_cb, bool vec_x,
                           bool vec_w) {
  using C = Cfg<NT>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  int bid = blockIdx.x;
  const int cb = bid % n_cb;
  bid /= n_cb;
  const int tw = bid % n_tw;
  bid /= n_tw;
  const int n = bid / n_th;
  const int h0 = (bid - n * n_th) * TILE_H;
  const int w0 = tw * TILE_W;
  const int co0 = cb * C::NB;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group / thread

  // The flag: any pixel > 0 in this block's granule of out_mask.
  {
    const int gh0 = h0 / gth * gth, gw0 = w0 / gtw * gtw;
    const int rows = min(gth, H - gh0), cols = min(gtw, W - gw0);
    const float* mg = mask + ((size_t)n * H + gh0) * W + gw0;
    int any = 0;
    for (int e = threadIdx.x; e < rows * cols && !any; e += THREADS) {
      const int r = e / cols;
      any = mg[(size_t)r * W + e - r * cols] > 0.f;
    }
    if (!__syncthreads_or(any)) {
      const int rows_o = min(TILE_H, H - h0), cols_o = min(TILE_W, W - w0);
      const int nb = min(C::NB, Cout - co0);
      for (int e = threadIdx.x; e < rows_o * cols_o * nb; e += THREADS) {
        const int j = e % nb;
        const int p = e / nb;
        const int r = p / cols_o, c = p - r * cols_o;
        out[(((size_t)n * H + h0 + r) * W + w0 + c) * Cout + co0 + j] = 0.f;
      }
      return;
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;

  constexpr int CK = C::CK, KS = C::KS, CKP = C::CKP, WP = C::WP;
  uint32_t* whi = reinterpret_cast<uint32_t*>(smem + 2 * C::STAGE);
  uint32_t* wlo = whi + C::WTS;
  const float* xn = x + (size_t)n * H * W * Cin;
  const bool row_ok = h0 + warp < H;
  const int n_mt = min(MT, (W - w0 + 15) / 16);  // m16 tiles left of W
  const int n_chunks = (Cin + CK - 1) / CK;

  stage_chunk<NT>(smem, smem + C::WIN, xn, w, h0, w0, 0, co0, H, W, Cin,
                  Cout, pad_mode, vec_x, vec_w);
  for (int kc = 0; kc < n_chunks; ++kc) {
    const float* xs = smem + (kc & 1) * C::STAGE;
    const float* ws = xs + C::WIN;
    cp_async_wait<0>();  // chunk kc, the only copy in flight, has landed
    __syncthreads();     // ... for every thread; chunk kc - 1 is consumed
    if (kc + 1 < n_chunks) {  // lands while chunk kc is computed
      float* nx = smem + ((kc + 1) & 1) * C::STAGE;
      stage_chunk<NT>(nx, nx + C::WIN, xn, w, h0, w0, (kc + 1) * CK, co0, H,
                      W, Cin, Cout, pad_mode, vec_x, vec_w);
    }
    // split the chunk's weights once for all warps
    for (int e = threadIdx.x; e < 9 * CK * C::NB / 4; e += THREADS) {
      const int idx = (e / (C::NB / 4)) * WP + 4 * (e % (C::NB / 4));
      const float4 v = *reinterpret_cast<const float4*>(ws + idx);
      uint4 hi, lo;
      split_tf32(v.x, hi.x, lo.x);
      split_tf32(v.y, hi.y, lo.y);
      split_tf32(v.z, hi.z, lo.z);
      split_tf32(v.w, hi.w, lo.w);
      *reinterpret_cast<uint4*>(whi + idx) = hi;
      *reinterpret_cast<uint4*>(wlo + idx) = lo;
    }
    __syncthreads();

    if (row_ok) {
#pragma unroll 1
      for (int tap = 0; tap < 9; ++tap) {
        const int ky = tap / 3, kx = tap - 3 * ky;
        uint32_t bh[KS][NT][2], bl[KS][NT][2];
#pragma unroll
        for (int s = 0; s < KS; ++s) {
          const int b = (tap * CK + 8 * s + t) * WP + g;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            bh[s][j][0] = whi[b + j * 8];
            bl[s][j][0] = wlo[b + j * 8];
            bh[s][j][1] = whi[b + 4 * WP + j * 8];
            bl[s][j][1] = wlo[b + 4 * WP + j * 8];
          }
        }
        const float* xp = xs + ((warp + ky) * WIN_W + kx + g) * CKP + t;
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          if (i < n_mt) {
            uint32_t ah[KS][4], al[KS][4];
#pragma unroll
            for (int s = 0; s < KS; ++s) {
              const float* p = xp + i * 16 * CKP + 8 * s;
              split_tf32(p[0], ah[s][0], al[s][0]);            // (g, t)
              split_tf32(p[8 * CKP], ah[s][1], al[s][1]);      // (g + 8, t)
              split_tf32(p[4], ah[s][2], al[s][2]);            // (g, t + 4)
              split_tf32(p[8 * CKP + 4], ah[s][3], al[s][3]);  // (g+8, t+4)
            }
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              // this tap's products start from zero and join the running
              // sum with one rounded add: the tensor cores round their f32
              // sums toward zero, and such roundings of a large
              // accumulator at every step would drift by ~1e-4 over
              // K = 2304
              float d[4];
              mma_tf32_first(d, al[0], bh[0][j][0], bh[0][j][1]);
              mma_tf32(d, ah[0], bl[0][j][0], bl[0][j][1]);
              mma_tf32(d, ah[0], bh[0][j][0], bh[0][j][1]);
#pragma unroll
              for (int s = 1; s < KS; ++s) {
                mma_tf32(d, al[s], bh[s][j][0], bh[s][j][1]);
                mma_tf32(d, ah[s], bl[s][j][0], bl[s][j][1]);
                mma_tf32(d, ah[s], bh[s][j][0], bh[s][j][1]);
              }
#pragma unroll
              for (int k = 0; k < 4; ++k) acc[i][j][k] += d[k];
            }
          }
        }
      }
    }
  }

  if (!row_ok) return;
  const int h = h0 + warp;
  const bool pairs = Cout % 2 == 0;  // (co, co + 1) is one aligned float2
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int col = w0 + i * 16 + g + 8 * half;
      if (i >= n_mt || col >= W) continue;
      const size_t pix = ((size_t)n * H + h) * W + col;
      const float m = mask[pix];
      float* o = out + pix * Cout;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int co = co0 + j * 8 + 2 * t;
        if (co >= Cout) continue;
        const float v0 =
            apply_nonlin(acc[i][j][2 * half] + bias[co], nonlin) * m;
        if (co + 1 < Cout) {
          const float v1 =
              apply_nonlin(acc[i][j][2 * half + 1] + bias[co + 1], nonlin) *
              m;
          if (pairs) {
            *reinterpret_cast<float2*>(o + co) = make_float2(v0, v1);
          } else {
            o[co] = v0;
            o[co + 1] = v1;
          }
        } else {
          o[co] = v0;
        }
      }
    }
  }
}

// Above 48 KB a block's dynamic shared memory must be allowed explicitly,
// once per device.
template <int NT>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(tile_sparse_conv3x3_kernel<NT>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Cfg<NT>::SMEM_BYTES);
  if (err == cudaSuccess && device < 64) done[device] = true;
  return err;
}

template <int NT>
cudaError_t launch(const float* x, const float* w, const float* b,
                   const float* mask, float* out, int N, int H, int W,
                   int Cin, int Cout, int pad_mode, int nonlin, int gth,
                   int gtw, cudaStream_t stream) {
  using C = Cfg<NT>;
  cudaError_t err = allow_smem<NT>();
  if (err != cudaSuccess) return err;
  const int n_th = (H + TILE_H - 1) / TILE_H;
  const int n_tw = (W + TILE_W - 1) / TILE_W;
  const int n_cb = (Cout + C::NB - 1) / C::NB;
  const long long blocks = (long long)N * n_th * n_tw * n_cb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // 16-byte staging needs whole, aligned groups of 4 channels
  const bool vec_x = Cin % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool vec_w = Cout % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  tile_sparse_conv3x3_kernel<NT><<<(unsigned)blocks, THREADS, C::SMEM_BYTES,
                                   stream>>>(
      x, w, b, mask, out, H, W, Cin, Cout, pad_mode, nonlin, gth, gtw, n_th,
      n_tw, n_cb, vec_x, vec_w);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns the CUDA error code
// (0 on success). All tensors are contiguous float32: x (N, H, W, Cin),
// w (3, 3, Cin, Cout), b (Cout), mask (N, H, W), out (N, H, W, Cout); out
// must be 8-byte aligned. The flag granule is gth rows x gtw columns; the
// caller guarantees gth % 8 == 0 and (gtw % 64 == 0 or gtw >= W), so each
// block lies in one granule.
int tile_sparse_conv3x3_f32(const float* x, const float* w, const float* b,
                            const float* mask, float* out, int N, int H,
                            int W, int Cin, int Cout, int pad_mode,
                            int nonlin, int gth, int gtw, int device,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 8)
    err = launch<1>(x, w, b, mask, out, N, H, W, Cin, Cout, pad_mode, nonlin,
                    gth, gtw, s);
  else
    err = launch<4>(x, w, b, mask, out, N, H, W, Cin, Cout, pad_mode, nonlin,
                    gth, gtw, s);
  return (int)err;
}

const char* tile_sparse_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
