// One sparse wavelet-decoder scale fused per (image, tile), float32, for
// Hopper (sm_90a).
//
// Per high-res tile (ht x tw; its low-res tile is ht/2 x tw/2), from
// inputs the caller has padded and masked:
//   x0 = elu(conv3x3(x window, w0) + b0) * m_u0                 low res
//   u  = upsample2x(x0) * m_up
//   x1 = elu(conv3x3(u, w1[:, :, :Cd]) + conv3x3(skip, w1[:, :, Cd:])
//            + b1) * m_u1                        (split weights, no concat)
//   hp = leaky01(x1 . wp1 + bp1) * m_u1,  hn likewise with wn1, bn1
//   yh = 2^(i-1) * (sigmoid(conv3x3(hp, wp3) + bp3)
//                   - sigmoid(conv3x3(hn, wn3) + bn3)) * m_wv
//   phases = yl/2 +- yh/2 (the Haar IDWT butterfly), x1's interior
// A tile whose flag is 0 (its upconv1 mask window is empty) writes zero
// yh, zero x1 and the yl-only butterfly.
//
// Replaces the TPU Pallas kernel K2 of
// wavelet_monodepth_tpu/ops/pallas_fused.py, fused_wave_stage
// (_fused_kernel, one grid step per (image, tile), everything in VMEM).
//
// What bounds it on the H100: float32 FMAs on the CUDA cores for the
// active tiles (upconv1 dominates: 9 * (Cd + Cs) * Cd per pixel of the
// (ht+2) x (tw+2) halo tile), and, in this first version, the loads that
// feed them. Its bytes (each input read once, the outputs written once)
// take a fraction of that at 3.35 TB/s.
// What the design does about it:
//   * one block per (tile, image), 256 threads; each thread item is 4
//     pixels x 4 output channels (16 accumulators), so every weight
//     float4 feeds 16 FMAs, and the threads of a warp share pixels when
//     Cd >= 128 (the input loads are broadcasts);
//   * x0, the low-res tile (6 x 34 x Cd floats, 104 KB at Cd = 128), stays
//     in shared memory; the upsample is an index (r/2, c/2) into it;
//   * x1 and the two heads' 1x1 outputs do not fit beside it (a
//     10 x 66 x 128 x1 is 338 KB): each block keeps them in its own slice
//     of a global scratch the wrapper allocates, written and read back
//     by the same block, so they stay in L2;
//   * the 4 phases are separated by __syncthreads(); padding happened in
//     the wrapper, so the kernel reads windows without bounds checks.
// Tensor cores (3xTF32 wgmma), TMA staging and keeping x1 on chip are
// later work.

#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int THREADS = 256;
constexpr int PX = 4;  // pixels per thread item
constexpr int CQ = 4;  // output channels per thread item

struct Args {
  const float *x, *skip, *yl, *m_u0, *m_up, *m_u1, *m_wv;
  const int* flags;
  const float *w0, *b0, *w1, *b1, *wp1, *bp1, *wp3, *bp3, *wn1, *bn1,
      *wn3, *bn3;
  float *yh, *ph, *x1, *scratch;
  int n_h, n_w, cx, cs, cd, ht, tw;
  float yscale;
};

// The Pallas kernel's epilogues (pallas_conv.py:44-57).
__device__ __forceinline__ float elu_f(float v) {
  return v > 0.f ? v : expf(v) - 1.f;
}
__device__ __forceinline__ float sigmoid_f(float v) {
  return 1.f / (1.f + expf(-v));
}
__device__ __forceinline__ float leaky01(float v) {
  return v > 0.f ? v : 0.1f * v;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void fma4(float (&acc)[CQ], float v, float4 w) {
  acc[0] = fmaf(v, w.x, acc[0]);
  acc[1] = fmaf(v, w.y, acc[1]);
  acc[2] = fmaf(v, w.z, acc[2]);
  acc[3] = fmaf(v, w.w, acc[3]);
}

__global__ void __launch_bounds__(THREADS)
fused_wave_stage_kernel(Args a) {
  extern __shared__ __align__(16) float x0s[];  // (hl+2, wl+2, Cd)
  const int t = blockIdx.x, n = blockIdx.y;
  const int n_t = a.n_h * a.n_w;
  const int ty = t / a.n_w, tx = t % a.n_w;
  const int ht = a.ht, tw = a.tw, hl = ht / 2, wl = tw / 2;
  const int cx = a.cx, cs = a.cs, cd = a.cd;
  const int HO = a.n_h * ht, WO = a.n_w * tw;  // canvases, yl, m_wv
  const int r0 = ty * ht, c0 = tx * tw;        // the tile's origin
  const float* ylb = a.yl + ((size_t)n * HO + r0) * WO + c0;
  const size_t obase = ((size_t)n * HO + r0) * WO + c0;

  if (a.flags[n * n_t + t] == 0) {
    for (int p = threadIdx.x; p < ht * tw; p += THREADS) {
      const int r = p / tw, c = p % tw;
      const size_t o = obase + (size_t)r * WO + c;
      const float lf = ylb[r * WO + c] * 0.5f;
      for (int j = 0; j < 3; ++j) a.yh[o * 3 + j] = 0.f;
      for (int j = 0; j < 4; ++j) a.ph[o * 4 + j] = lf;
    }
    for (int e = threadIdx.x; e < ht * tw * cd; e += THREADS) {
      const int p = e / cd, r = p / tw, c = p % tw;
      a.x1[(obase + (size_t)r * WO + c) * cd + e % cd] = 0.f;
    }
    return;
  }

  // ---- phase A: upconv0 + ELU at low res into shared memory -----------
  {
    const int rows = hl + 2, cols = wl + 2, npix = rows * cols;
    const int WX = a.n_w * wl + 4, HX = a.n_h * hl + 4;
    const int WM = a.n_w * wl + 2, HM = a.n_h * hl + 2;
    const float* xb =
        a.x + (((size_t)n * HX + ty * hl) * WX + (size_t)tx * wl) * cx;
    const float* mb = a.m_u0 + ((size_t)n * HM + ty * hl) * WM + tx * wl;
    const int nq = cd / CQ, ngrp = (npix + PX - 1) / PX;
    for (int it = threadIdx.x; it < ngrp * nq; it += THREADS) {
      const int q = it % nq, g = it / nq;
      float acc[PX][CQ] = {};
      int off[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = min(g * PX + j, npix - 1);
        off[j] = ((p / cols) * WX + p % cols) * cx;
      }
      for (int k = 0; k < 9; ++k) {
        const float* wk = a.w0 + (size_t)k * cx * cd + q * CQ;
        const int toff = ((k / 3) * WX + k % 3) * cx;
        for (int ci = 0; ci < cx; ++ci) {
          const float4 wv = ld4(wk + (size_t)ci * cd);
#pragma unroll
          for (int j = 0; j < PX; ++j) fma4(acc[j], xb[off[j] + toff + ci], wv);
        }
      }
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = g * PX + j;
        if (p >= npix) break;
        const float m = mb[(p / cols) * WM + p % cols];
#pragma unroll
        for (int i = 0; i < CQ; ++i)
          x0s[p * cd + q * CQ + i] = elu_f(acc[j][i] + a.b0[q * CQ + i]) * m;
      }
    }
  }
  __syncthreads();

  const int cols1 = tw + 2, npix1 = (ht + 2) * cols1;
  float* x1b = a.scratch + (size_t)(n * n_t + t) * npix1 * 3 * cd;
  float* hb = x1b + (size_t)npix1 * cd;  // (ht+2, tw+2, 2 Cd)
  const int WU = a.n_w * tw + 2, HU = a.n_h * ht + 2;
  const float* u1b = a.m_u1 + ((size_t)n * HU + r0) * WU + c0;

  // ---- phase B: upconv1 over upsample(x0) and the skip, + ELU ---------
  {
    const int WS = a.n_w * tw + 4, HS = a.n_h * ht + 4;
    const float* sb = a.skip + (((size_t)n * HS + r0) * WS + c0) * cs;
    const float* upb = a.m_up + ((size_t)n * HS + r0) * WS + c0;
    const int cin = cd + cs, nq = cd / CQ, ngrp = (npix1 + PX - 1) / PX;
    for (int it = threadIdx.x; it < ngrp * nq; it += THREADS) {
      const int q = it % nq, g = it / nq;
      float acc[PX][CQ] = {};
      int pr[PX], pc[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = min(g * PX + j, npix1 - 1);
        pr[j] = p / cols1;
        pc[j] = p % cols1;
      }
      for (int k = 0; k < 9; ++k) {
        const float* wk = a.w1 + (size_t)k * cin * cd + q * CQ;
        int xo[PX], so[PX];
        float mu[PX];
#pragma unroll
        for (int j = 0; j < PX; ++j) {
          const int R = pr[j] + k / 3, C = pc[j] + k % 3;
          mu[j] = upb[R * WS + C];
          xo[j] = ((R >> 1) * (wl + 2) + (C >> 1)) * cd;
          so[j] = (R * WS + C) * cs;
        }
        for (int ci = 0; ci < cd; ++ci) {
          const float4 wv = ld4(wk + (size_t)ci * cd);
#pragma unroll
          for (int j = 0; j < PX; ++j)
            fma4(acc[j], x0s[xo[j] + ci] * mu[j], wv);
        }
        for (int ci = 0; ci < cs; ++ci) {
          const float4 wv = ld4(wk + (size_t)(cd + ci) * cd);
#pragma unroll
          for (int j = 0; j < PX; ++j) fma4(acc[j], sb[so[j] + ci], wv);
        }
      }
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = g * PX + j;
        if (p >= npix1) break;
        const float m = u1b[pr[j] * WU + pc[j]];
#pragma unroll
        for (int i = 0; i < CQ; ++i)
          x1b[p * cd + q * CQ + i] = elu_f(acc[j][i] + a.b1[q * CQ + i]) * m;
      }
    }
  }
  __syncthreads();

  // ---- phase C: the pos and neg heads' 1x1 + LeakyReLU(0.1) -----------
  {
    const int nq = 2 * cd / CQ, ngrp = (npix1 + PX - 1) / PX;
    for (int it = threadIdx.x; it < ngrp * nq; it += THREADS) {
      const int q = it % nq, g = it / nq;
      const bool neg = q * CQ >= cd;
      const int cc = q * CQ - (neg ? cd : 0);
      const float* w = (neg ? a.wn1 : a.wp1) + cc;
      const float* b = (neg ? a.bn1 : a.bp1) + cc;
      float acc[PX][CQ] = {};
      int p0[PX];
#pragma unroll
      for (int j = 0; j < PX; ++j) p0[j] = min(g * PX + j, npix1 - 1) * cd;
      for (int ci = 0; ci < cd; ++ci) {
        const float4 wv = ld4(w + (size_t)ci * cd);
#pragma unroll
        for (int j = 0; j < PX; ++j) fma4(acc[j], x1b[p0[j] + ci], wv);
      }
#pragma unroll
      for (int j = 0; j < PX; ++j) {
        const int p = g * PX + j;
        if (p >= npix1) break;
        const float m = u1b[(p / cols1) * WU + p % cols1];
#pragma unroll
        for (int i = 0; i < CQ; ++i)
          hb[p * 2 * cd + q * CQ + i] = leaky01(acc[j][i] + b[i]) * m;
      }
    }
  }
  __syncthreads();

  // ---- phase D: the heads' 3x3 + sigmoid, yh, the IDWT phases, x1 -----
  const float* wvb = a.m_wv + ((size_t)n * HO + r0) * WO + c0;
  for (int p = threadIdx.x; p < ht * tw; p += THREADS) {
    const int r = p / tw, c = p % tw;
    float pos[3] = {0.f, 0.f, 0.f}, ngv[3] = {0.f, 0.f, 0.f};
    for (int k = 0; k < 9; ++k) {
      const float* h = hb + ((r + k / 3) * cols1 + c + k % 3) * 2 * cd;
      const float* wp = a.wp3 + (size_t)k * cd * 3;
      const float* wn = a.wn3 + (size_t)k * cd * 3;
      for (int ci = 0; ci < cd; ++ci) {
        const float hp = h[ci], hn = h[cd + ci];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          pos[j] = fmaf(hp, wp[ci * 3 + j], pos[j]);
          ngv[j] = fmaf(hn, wn[ci * 3 + j], ngv[j]);
        }
      }
    }
    const float m = wvb[r * WO + c];
    float yh[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      yh[j] = a.yscale * (sigmoid_f(pos[j] + a.bp3[j]) -
                          sigmoid_f(ngv[j] + a.bn3[j])) * m;
    const float lf = ylb[r * WO + c] * 0.5f;
    const float h0 = yh[0] * 0.5f, h1 = yh[1] * 0.5f, h2 = yh[2] * 0.5f;
    const size_t o = obase + (size_t)r * WO + c;
#pragma unroll
    for (int j = 0; j < 3; ++j) a.yh[o * 3 + j] = yh[j];
    a.ph[o * 4 + 0] = lf + h0 + h1 + h2;
    a.ph[o * 4 + 1] = lf + h0 - h1 - h2;
    a.ph[o * 4 + 2] = lf - h0 + h1 - h2;
    a.ph[o * 4 + 3] = lf - h0 - h1 + h2;
  }
  for (int e = threadIdx.x; e < ht * tw * cd; e += THREADS) {
    const int p = e / cd, r = p / tw, c = p % tw, ch = e % cd;
    a.x1[(obase + (size_t)r * WO + c) * cd + ch] =
        x1b[((r + 1) * cols1 + c + 1) * cd + ch];
  }
}

}  // namespace

extern "C" {

// Launches on `stream` of device `device` and returns cudaGetLastError()
// after the launch (0 on success). All tensors are contiguous float32
// (flags int32) with 16-byte aligned weights, as the wrapper lays them
// out: x (N, nH*ht/2+4, nW*tw/2+4, Cx) and skip (N, nH*ht+4, nW*tw+4, Cs)
// padded; yl and m_wv (N, nH*ht, nW*tw); m_u0 (N, nH*ht/2+2,
// nW*tw/2+2), m_up (N, nH*ht+4, nW*tw+4), m_u1 (N, nH*ht+2, nW*tw+2);
// flags (N, nH, nW); HWIO weights w0 (3,3,Cx,Cd), w1 (3,3,Cd+Cs,Cd), wp1
// and wn1 (Cd,Cd), wp3 and wn3 (3,3,Cd,3); outputs yh (N, nH*ht, nW*tw,
// 3), ph (.., 4), x1 (.., Cd); scratch nH*nW*N*(ht+2)*(tw+2)*3*Cd floats.
// Cd % 4 == 0 and (ht/2+2)*(tw/2+2)*Cd floats fit a block's shared memory.
int fused_wave_stage_f32(const float* x, const float* skip, const float* yl,
                         const float* m_u0, const float* m_up,
                         const float* m_u1, const float* m_wv,
                         const int* flags, const float* w0, const float* b0,
                         const float* w1, const float* b1, const float* wp1,
                         const float* bp1, const float* wp3,
                         const float* bp3, const float* wn1,
                         const float* bn1, const float* wn3,
                         const float* bn3, float* yh, float* ph, float* x1,
                         float* scratch, int N, int n_h, int n_w, int cx,
                         int cs, int cd, int ht, int tw, int i_scale,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (cd % CQ != 0 || ht % 2 || tw % 2 || N > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x,   skip, yl,  m_u0, m_up, m_u1, m_wv, flags, w0, b0,  w1, b1,
         wp1, bp1,  wp3, bp3,  wn1,  bn1,  wn3,  bn3,   yh, ph,  x1, scratch,
         n_h, n_w,  cx,  cs,   cd,   ht,   tw,   std::ldexp(1.0f, i_scale - 1)};
  const size_t smem = (size_t)(ht / 2 + 2) * (tw / 2 + 2) * cd * sizeof(float);
  err = cudaFuncSetAttribute(fused_wave_stage_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(n_h * n_w, N);
  fused_wave_stage_kernel<<<grid, THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

const char* fused_wave_stage_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
