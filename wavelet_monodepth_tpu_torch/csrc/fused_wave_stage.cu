// One sparse wavelet-decoder scale fused per (image, tile), float32
// accuracy on Hopper's tensor cores (sm_90a), in 3xTF32.
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
// What bounds it on the H100: the multiply-adds of the active tiles, at
// float32 accuracy. Upconv1 dominates (9 * (Cd + Cs) * Cd per pixel of
// the (ht+2) x (tw+2) halo tile), then upconv0 (9 * Cx * Cd per low-res
// halo pixel), the 1x1 heads (2 * Cd^2) and the 3x3 Cout=3 heads. The
// fastest float32-accurate route is 3xTF32 on the tensor cores, a third
// of the dense TF32 rate (495 / 3 = 165 TFLOP/s against 67 of f32 FMAs);
// the bytes take a fraction of that at 3.35 TB/s.
// What the design does about it:
//   * one block per (tile, image), 16 warps; every phase is an implicit
//     GEMM on mma.sync.aligned.m16n8k8 TF32 over the tile's pixels:
//       phase | M (pixels)           | N       | K            | A operand
//       A     | (ht/2+2)(tw/2+2)=204 | Cd      | 9 Cx         | x window
//       B     | (ht+2)(tw+2) = 660   | Cd      | 9 (Cd + Cs)  | x0 at
//             |                      |         |              | (R>>1, C>>1)
//             |                      |         |              | * m_up, skip
//       C     | 660                  | 2 Cd    | Cd           | x1
//       D     | ht tw = 512          | 8 (3+3) | 9 * 2 Cd     | [hp | hn]
//     (widths at the default 8 x 64 tile). The A operand of tap (ky, kx)
//     is a shifted view of a window in shared memory; no im2col exists.
//     Phase D is one GEMM whose B is block-diagonal: columns 0-2 take wp3
//     on hp's channels, columns 3-5 wn3 on hn's;
//   * 3xTF32 as in csrc/tile_sparse_conv.cu: each operand v is split into
//     hi = tf32(v) and lo = v - hi, and lo*hi + hi*lo + hi*hi is summed.
//     The tensor cores round their f32 sums toward zero, so each tap's
//     three products (one k8 step of an 8-channel chunk) start from zero
//     and join the running f32 sum with one rounded add;
//   * each warp owns up to MT m16 tiles (m tile i of the phase goes to
//     warp i % 16) and all NT n8 tiles of an N slice of 8 * NT output
//     channels; the output channels are walked in slices, so the
//     accumulators fit the registers (3 x 4 x 4 floats in phase B), and
//     the A operand is re-staged (from x0 in shared memory, or from L2:
//     skip, x1, heads) for every slice. Four warps per scheduler hide
//     the MMAs' latency better than two (1.2x on the H100), though 512
//     threads cap a thread at 128 registers and ptxas spills ~100 bytes.
//     A warp whose last m tile lies past M multiplies a copy of M's last
//     row and stores nothing: the MMA loop has no branch, so no warp
//     reconverges inside it (3% on the H100);
//   * the staged windows (8 channels per chunk, pixel stride 12 floats)
//     and the chunk's weights for all taps (rows padded to 40 floats) are
//     copied with cp.async into one of two buffers while the MMAs consume
//     the other, so every fragment load of a warp hits 32 distinct
//     banks; the weights are split into hi/lo as they are loaded;
//   * x0 (the upconv0 output over the low-res halo tile) stays in shared
//     memory, its pixel stride Cd + 4 (or + 8, so it is 4 mod 8); each
//     8-channel chunk of upsample(x0) * m_up is copied from it into the
//     stage buffer, pixel (R, C) from x0's (R >> 1, C >> 1) times m_up (a
//     window in shared memory), so both parts of upconv1's K read one
//     kind of window and the concat never exists;
//   * x1 and the two heads' 1x1 outputs do not fit beside it (a
//     10 x 66 x 128 x1 is 338 KB): each block keeps them in its own slice
//     of a global scratch the wrapper allocates, written and read back by
//     the same block, so they stay in L2. Phase B writes x1's interior to
//     the output as it writes the scratch;
//   * the phases are separated by __syncthreads(); padding happened in
//     the wrapper, so the kernel reads windows without bounds checks.
// Shared memory, floats (the default 8 x 64 tile):
//   x0     (ht/2+2)(tw/2+2)(Cd+4)   [later phase D's 8 sums per pixel]
//   m_up   (ht+4)(tw+4)                                    =   816
//   2 x [ window (ht+4)(tw+4) * 12 = 9792, weights 9*8*40 = 2880 ]
//   scale 3 (Cx 256, Cs 128, Cd 128): 26928 + 816 + 25344 = 212,352 B
//   scale 2 (Cx 128, Cs  64, Cd  64): 13872 + 816 + 25344 = 160,128 B
//   scale 1 (Cx  64, Cs  64, Cd  32):  7344 + 816 + 25344 = 134,016 B
// of a block's 232,448, so one block per SM; at the default tile Cd is
// at most 152. A cluster that shares x0 through DSMEM, TMA and wgmma,
// and keeping x1 on chip are later work.

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int CK = 8;           // input channels per stage: one k8 step
constexpr int CKP = CK + 4;     // staged pixel stride, 4 mod 8
constexpr int WTS = 9 * CK * 40;  // a stage's weights, rows of <= 40

enum Phase { PH_UP0 = 0, PH_UP1 = 1, PH_HEAD1 = 2, PH_HEAD3 = 3 };

struct Args {
  const float *x, *skip, *yl, *m_u0, *m_up, *m_u1, *m_wv;
  const int* flags;
  const float *w0, *b0, *w1, *b1, *wp1, *bp1, *wp3, *bp3, *wn1, *bn1,
      *wn3, *bn3;
  float *yh, *ph, *x1, *scratch;
  int n_h, n_w, cx, cs, cd, ht, tw;
  float yscale;
};

// One block's tile: its window origins and the widths of its canvases.
struct Tile {
  int ht, tw, hl, wl, cx, cs, cd, x0p;
  int WX, WM, WS, WU, WO;       // row lengths of x, m_u0, skip, m_u1, yl
  int stage_floats;             // one buffer: window + weights
  const float *xb, *sb, *mu0, *mu1;
  float *x1b, *hb;
  size_t obase;                 // the tile's first output pixel
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// v = hi + lo: hi is v rounded to TF32 (10 mantissa bits, to nearest,
// ties away from zero: what cvt.rna.tf32.f32 computes, here as two
// integer operations), lo = v - hi exactly; the MMA reads lo's leading 10
// mantissa bits, so v is kept to ~2^-21 of itself.
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

// A phase's GEMM shape: M output pixels in rows of OW, read through taps
// from a source window with rows of SW pixels; K = taps x (k0 + k1)
// input channels (k1: upconv1's skip, after x0's k0); ncol outputs.
struct Shape {
  int M, OW, SW, npix, taps, k0, k1, ncol;
};

template <int PH>
__device__ __forceinline__ Shape shape_of(const Tile& c) {
  const int halo = (c.ht + 2) * (c.tw + 2);
  switch (PH) {
    case PH_UP0:
      return {(c.hl + 2) * (c.wl + 2), c.wl + 2, c.wl + 4,
              (c.hl + 4) * (c.wl + 4), 9, c.cx, 0, c.cd};
    case PH_UP1:
      return {halo, c.tw + 2, c.tw + 4, (c.ht + 4) * (c.tw + 4), 9, c.cd,
              c.cs, c.cd};
    case PH_HEAD1:
      return {halo, c.tw + 2, c.tw + 2, halo, 1, c.cd, 0, 2 * c.cd};
    default:
      return {c.ht * c.tw, c.tw, c.tw + 2, halo, 9, 2 * c.cd, 0, 8};
  }
}

// Source of input channel ch of staged window pixel pix.
template <int PH>
__device__ __forceinline__ const float* window_src(const Tile& c, int pix,
                                                   int ch) {
  switch (PH) {
    case PH_UP0: {
      const int r = pix / (c.wl + 4), col = pix - r * (c.wl + 4);
      return c.xb + ((size_t)r * c.WX + col) * c.cx + ch;
    }
    case PH_UP1: {
      const int r = pix / (c.tw + 4), col = pix - r * (c.tw + 4);
      return c.sb + ((size_t)r * c.WS + col) * c.cs + ch;
    }
    case PH_HEAD1:
      return c.x1b + (size_t)pix * c.cd + ch;
    default:
      return c.hb + (size_t)pix * 2 * c.cd + ch;
  }
}

// Weight of (tap k, input channel ci, output co) of part `part`, or
// nullptr where it is zero.
template <int PH>
__device__ __forceinline__ const float* weight_src(const Args& a,
                                                   const Tile& c, int k,
                                                   int ci, int co, int part) {
  const int cd = c.cd;
  switch (PH) {
    case PH_UP0:
      return ci < c.cx && co < cd ? a.w0 + ((size_t)k * c.cx + ci) * cd + co
                                  : nullptr;
    case PH_UP1:
      if (co >= cd || ci >= (part ? c.cs : cd)) return nullptr;
      return a.w1 + ((size_t)k * (cd + c.cs) + (part ? cd : 0) + ci) * cd +
             co;
    case PH_HEAD1:
      if (ci >= cd || co >= 2 * cd) return nullptr;
      return co < cd ? a.wp1 + (size_t)ci * cd + co
                     : a.wn1 + (size_t)ci * cd + co - cd;
    default:  // block-diagonal: [hp | hn] x [[wp3, 0], [0, wn3]]
      if (ci < cd && co < 3) return a.wp3 + ((size_t)k * cd + ci) * 3 + co;
      if (ci >= cd && ci < 2 * cd && co >= 3 && co < 6)
        return a.wn3 + ((size_t)k * cd + ci - cd) * 3 + co - 3;
      return nullptr;
  }
}

// Stages input channels [c0, c0 + CK) of part `part` of the phase's
// source window into xs[npix][CKP] and their weights for every tap and
// the N slice's output channels into ws[taps][CK][WP], asynchronously
// (one commit group per call). Upconv1's first part, upsample(x0) * m_up,
// is copied from shared memory as it is read: x0 pixel (R >> 1, C >> 1)
// times m_up's (R, C).
template <int PH, int NB>
__device__ __forceinline__ void stage(const Args& a, const Tile& c,
                                      const Shape& s, const float* x0s,
                                      const float* mups, float* xs,
                                      float* ws, int co0, int part, int c0) {
  constexpr int WP = NB % 16 == 8 ? NB : NB + 8;
  if (PH == PH_UP1 && part == 0) {
    for (int e = threadIdx.x; e < s.npix * (CK / 4); e += THREADS) {
      const int q = e % (CK / 4), pix = e / (CK / 4);
      const int R = pix / (c.tw + 4), C = pix - R * (c.tw + 4);
      const float m = mups[pix];
      float4 v = *reinterpret_cast<const float4*>(
          x0s + ((R >> 1) * (c.wl + 2) + (C >> 1)) * c.x0p + c0 + 4 * q);
      v.x *= m;
      v.y *= m;
      v.z *= m;
      v.w *= m;
      *reinterpret_cast<float4*>(xs + pix * CKP + 4 * q) = v;
    }
  } else {
    const int cin = PH == PH_UP0 ? c.cx
                  : PH == PH_UP1 ? c.cs
                  : PH == PH_HEAD1 ? c.cd : 2 * c.cd;
    if (cin % 4 == 0) {
      for (int e = threadIdx.x; e < s.npix * (CK / 4); e += THREADS) {
        const int q = e % (CK / 4), pix = e / (CK / 4);
        const int ch = c0 + 4 * q;
        const bool ok = ch < cin;
        cp_async16(xs + pix * CKP + 4 * q,
                   ok ? window_src<PH>(c, pix, ch) : a.w0, ok);
      }
    } else {
      for (int e = threadIdx.x; e < s.npix * CK; e += THREADS) {
        const int ci = e % CK, pix = e / CK;
        const bool ok = c0 + ci < cin;
        cp_async4(xs + pix * CKP + ci,
                  ok ? window_src<PH>(c, pix, c0 + ci) : a.w0, ok);
      }
    }
  }
  if (PH != PH_HEAD3) {  // rows of Cd (or 2 Cd) floats: whole float4s
    for (int e = threadIdx.x; e < s.taps * CK * (NB / 4); e += THREADS) {
      const int co = 4 * (e % (NB / 4));
      const int ci = (e / (NB / 4)) % CK, k = e / ((NB / 4) * CK);
      const float* src = weight_src<PH>(a, c, k, c0 + ci, co0 + co, part);
      cp_async16(ws + (k * CK + ci) * WP + co, src ? src : a.w0,
                 src != nullptr);
    }
  } else {
    for (int e = threadIdx.x; e < s.taps * CK * NB; e += THREADS) {
      const int co = e % NB, ci = (e / NB) % CK, k = e / (NB * CK);
      const float* src = weight_src<PH>(a, c, k, c0 + ci, co0 + co, part);
      cp_async4(ws + (k * CK + ci) * WP + co, src ? src : a.w0,
                src != nullptr);
    }
  }
  cp_async_commit();
}

// One phase: for every N slice (and group of 8 * MT m16 tiles), the
// chunks of K in order, each staged while the previous one is
// multiplied, then the phase's epilogue on the accumulators.
template <int PH, int NT, int MT>
__device__ __forceinline__ void run_phase(const Args& a, const Tile& c,
                                          float* x0s, const float* mups,
                                          float* stg) {
  constexpr int NB = 8 * NT;
  constexpr int WP = NB % 16 == 8 ? NB : NB + 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;  // the fragments' group / thread
  const Shape s = shape_of<PH>(c);
  const int n_sl = (s.ncol + NB - 1) / NB, n_mt = (s.M + 15) / 16;
  const int n_mg = (n_mt + WARPS * MT - 1) / (WARPS * MT);
  const int nk0 = (s.k0 + CK - 1) / CK, nk1 = (s.k1 + CK - 1) / CK;
  const int per = nk0 + nk1, total = n_sl * n_mg * per;
  const int src_floats = c.stage_floats - WTS;

  float acc[MT][NT][4];
  int off[MT][2];  // window offset of fragment rows g, g + 8 at tap (0, 0)

  stage<PH, NB>(a, c, s, x0s, mups, stg, stg + src_floats, 0, 0, 0);
  for (int kc = 0; kc < total; ++kc) {
    const int kk = kc % per, mg = (kc / per) % n_mg;
    const int sl = kc / (per * n_mg);
    if (kk == 0) {
#pragma unroll
      for (int i = 0; i < MT; ++i) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
        const int mt = (mg * MT + i) * WARPS + warp;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int p = min(mt * 16 + g + 8 * h, s.M - 1);
          const int r = p / s.OW;
          off[i][h] = (r * s.SW + p - r * s.OW) * CKP + t;
        }
      }
    }
    cp_async_wait_all();  // chunk kc, the only copy in flight, has landed
    __syncthreads();      // ... for every thread; chunk kc - 1 is consumed
    if (kc + 1 < total) {  // lands while chunk kc is multiplied
      const int nk = (kc + 1) % per;
      float* nx = stg + ((kc + 1) & 1) * c.stage_floats;
      stage<PH, NB>(a, c, s, x0s, mups, nx, nx + src_floats,
                    (kc + 1) / (per * n_mg) * NB, nk >= nk0,
                    (nk >= nk0 ? nk - nk0 : nk) * CK);
    }
    const float* xs = stg + (kc & 1) * c.stage_floats;
    const float* ws = xs + src_floats;

#pragma unroll 1
    for (int tap = 0; tap < s.taps; ++tap) {
      const int ky = tap / 3, kx = tap - 3 * ky;
      const float* xt = xs + (ky * s.SW + kx) * CKP;
      uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int b = (tap * CK + t) * WP + j * 8 + g;
        split_tf32(ws[b], bh[j][0], bl[j][0]);
        split_tf32(ws[b + 4 * WP], bh[j][1], bl[j][1]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {  // tiles past M repeat its last row
        const float v[4] = {xt[off[i][0]], xt[off[i][1]], xt[off[i][0] + 4],
                            xt[off[i][1] + 4]};  // (g|g+8, t|t+4)
        uint32_t ah[4], al[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) split_tf32(v[k], ah[k], al[k]);
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          // this tap's products start from zero and join the running sum
          // with one rounded add (the tensor cores round toward zero)
          float d[4];
          mma_tf32_first(d, al, bh[j][0], bh[j][1]);
          mma_tf32(d, ah, bl[j][0], bl[j][1]);
          mma_tf32(d, ah, bh[j][0], bh[j][1]);
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[i][j][k] += d[k];
        }
      }
    }
    if (kk != per - 1) continue;

    // ---- the epilogue of this N slice and m tile group ----------------
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int mt = (mg * MT + i) * WARPS + warp;
      if (mt >= n_mt) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = mt * 16 + g + 8 * h;
        if (p >= s.M) continue;
        const int r = p / s.OW, col = p - r * s.OW;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const int co = sl * NB + j * 8 + 2 * t;  // and co + 1: ncol even
          if (co >= s.ncol) continue;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (PH == PH_UP0) {
            const float m = c.mu0[r * c.WM + col];
            x0s[p * c.x0p + co] = elu_f(v0 + a.b0[co]) * m;
            x0s[p * c.x0p + co + 1] = elu_f(v1 + a.b0[co + 1]) * m;
          } else if (PH == PH_UP1) {
            const float m = c.mu1[r * c.WU + col];
            const float2 e = make_float2(elu_f(v0 + a.b1[co]) * m,
                                         elu_f(v1 + a.b1[co + 1]) * m);
            *reinterpret_cast<float2*>(c.x1b + (size_t)p * c.cd + co) = e;
            if (r >= 1 && r <= c.ht && col >= 1 && col <= c.tw)
              *reinterpret_cast<float2*>(
                  a.x1 + (c.obase + (size_t)(r - 1) * c.WO + col - 1) * c.cd +
                  co) = e;
          } else if (PH == PH_HEAD1) {
            const float m = c.mu1[r * c.WU + col];
            const float* b = co < c.cd ? a.bp1 + co : a.bn1 + co - c.cd;
            *reinterpret_cast<float2*>(c.hb + (size_t)p * 2 * c.cd + co) =
                make_float2(leaky01(v0 + b[0]) * m, leaky01(v1 + b[1]) * m);
          } else {  // the heads' 3x3 sums, bias added by the caller
            x0s[p * 8 + co] = v0;
            x0s[p * 8 + co + 1] = v1;
          }
        }
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
fused_wave_stage_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int t = blockIdx.x, n = blockIdx.y;
  const int n_t = a.n_h * a.n_w;
  const int ty = t / a.n_w, tx = t % a.n_w;
  const int ht = a.ht, tw = a.tw, hl = ht / 2, wl = tw / 2, cd = a.cd;
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

  Tile c;
  c.ht = ht; c.tw = tw; c.hl = hl; c.wl = wl;
  c.cx = a.cx; c.cs = a.cs; c.cd = cd;
  c.x0p = cd % 8 == 0 ? cd + 4 : cd + 8;
  c.WX = a.n_w * wl + 4;
  c.WM = a.n_w * wl + 2;
  c.WS = a.n_w * tw + 4;
  c.WU = a.n_w * tw + 2;
  c.WO = WO;
  c.stage_floats = (ht + 4) * (tw + 4) * CKP + WTS;
  const int HX = a.n_h * hl + 4, HM = a.n_h * hl + 2;
  const int HS = a.n_h * ht + 4, HU = a.n_h * ht + 2;
  c.xb = a.x + (((size_t)n * HX + ty * hl) * c.WX + (size_t)tx * wl) * c.cx;
  c.mu0 = a.m_u0 + ((size_t)n * HM + ty * hl) * c.WM + tx * wl;
  c.sb = a.skip + (((size_t)n * HS + r0) * c.WS + c0) * c.cs;
  c.mu1 = a.m_u1 + ((size_t)n * HU + r0) * c.WU + c0;
  const int npix1 = (ht + 2) * (tw + 2);
  c.x1b = a.scratch + (size_t)(n * n_t + t) * npix1 * 3 * cd;
  c.hb = c.x1b + (size_t)npix1 * cd;  // (ht+2, tw+2, 2 Cd)
  c.obase = obase;

  const int npix0 = (hl + 2) * (wl + 2);
  const int x0_floats = max(npix0 * c.x0p, ht * tw * 8);
  float* x0s = smem;
  float* mups = x0s + x0_floats;
  float* stg = mups + (ht + 4) * (tw + 4);

  // x0's pad channels are read by upconv1's last chunk: zeros, not NaNs
  const int padw = c.x0p - cd;
  for (int e = threadIdx.x; e < npix0 * padw; e += THREADS)
    x0s[(e / padw) * c.x0p + cd + e % padw] = 0.f;
  {
    const float* upb = a.m_up + ((size_t)n * HS + r0) * c.WS + c0;
    for (int e = threadIdx.x; e < (ht + 4) * (tw + 4); e += THREADS) {
      const int r = e / (tw + 4);
      mups[e] = upb[(size_t)r * c.WS + e - r * (tw + 4)];
    }
  }

  run_phase<PH_UP0, 4, 1>(a, c, x0s, mups, stg);    // x0 -> shared
  __syncthreads();
  run_phase<PH_UP1, 4, 3>(a, c, x0s, mups, stg);    // x1 -> scratch, out
  __syncthreads();
  run_phase<PH_HEAD1, 4, 3>(a, c, x0s, mups, stg);  // hp, hn -> scratch
  __syncthreads();
  run_phase<PH_HEAD3, 1, 2>(a, c, x0s, mups, stg);  // 3x3 sums -> shared
  __syncthreads();

  // ---- sigmoid, yh, the IDWT phases ------------------------------------
  const float* wvb = a.m_wv + obase;
  for (int p = threadIdx.x; p < ht * tw; p += THREADS) {
    const int r = p / tw, col = p % tw;
    const float* sum = x0s + p * 8;
    const float m = wvb[r * WO + col];
    float yh[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      yh[j] = a.yscale * (sigmoid_f(sum[j] + a.bp3[j]) -
                          sigmoid_f(sum[3 + j] + a.bn3[j])) * m;
    const float lf = ylb[r * WO + col] * 0.5f;
    const float h0 = yh[0] * 0.5f, h1 = yh[1] * 0.5f, h2 = yh[2] * 0.5f;
    const size_t o = obase + (size_t)r * WO + col;
#pragma unroll
    for (int j = 0; j < 3; ++j) a.yh[o * 3 + j] = yh[j];
    a.ph[o * 4 + 0] = lf + h0 + h1 + h2;
    a.ph[o * 4 + 1] = lf + h0 - h1 - h2;
    a.ph[o * 4 + 2] = lf - h0 + h1 - h2;
    a.ph[o * 4 + 3] = lf - h0 - h1 + h2;
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
// Cd % 4 == 0, and fused_wave_stage_smem_bytes(ht, tw, Cd) fits a
// block's shared memory.
int fused_wave_stage_smem_bytes(int ht, int tw, int cd) {
  const int x0p = cd % 8 == 0 ? cd + 4 : cd + 8;
  const int x0 = (ht / 2 + 2) * (tw / 2 + 2) * x0p;
  const int sums = ht * tw * 8;
  return 4 * ((x0 > sums ? x0 : sums) + (ht + 4) * (tw + 4) +
              2 * ((ht + 4) * (tw + 4) * CKP + WTS));
}

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
  if (cd % 4 != 0 || ht % 2 || tw % 2 || N > 65535)
    return (int)cudaErrorInvalidValue;
  Args a{x,   skip, yl,  m_u0, m_up, m_u1, m_wv, flags, w0, b0,  w1, b1,
         wp1, bp1,  wp3, bp3,  wn1,  bn1,  wn3,  bn3,   yh, ph,  x1, scratch,
         n_h, n_w,  cx,  cs,   cd,   ht,   tw,   std::ldexp(1.0f, i_scale - 1)};
  const int smem = fused_wave_stage_smem_bytes(ht, tw, cd);
  err = cudaFuncSetAttribute(fused_wave_stage_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
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
