// Backward of (I)GDN over the rows of a channel-minor (N, C) float32 or
// bfloat16 matrix.
//
// Replaces mmnc_tpu/ops/gdn_pallas.py:_bwd (:85-101), the custom VJP of
// gdn_pallas_2d, which XLA fuses around its three matrix products. With
// n = beta + x^2 gamma^T (gamma (C, C) in [out, in] layout) and g the
// gradient of the output, per row:
//   GDN:  r = rsqrt(n), u = g x r^3, dx = g r - x (u @ gamma)
//   IGDN: s = sqrt(n),  u = g x / s, dx = g s + x (u @ gamma)
// and over all rows dgamma = -+1/2 u^T x^2, dbeta = -+1/2 sum_rows u (- for
// GDN, + for IGDN). dx comes back in x's type, dgamma and dbeta in float32;
// a bf16 x and g are widened to float32 and dx is rounded once, at the
// store.
//
// Bound on the H100: each row reads x and g and writes dx (12 C bytes in
// float32) against three C x C products (3 C^2 FMAs): C/2 FLOP per byte.
// On the CUDA cores' float32 rate (67 TFLOP/s) the products bound it from
// C = 40 on; the path's C = 50 and 100 shapes hold most of its work.
//
// The products on the tensor cores (gdn_backward_mma_kernel, the plan's
// path at C 32-127, and at narrower C up to 65536 rows): mma.sync.m16n8k8
// in TF32 with float32
// accumulation, in 3xTF32 so that they stay float32-accurate. Each
// operand is split once, where it is made, into hi = tf32(a) (cvt.rna:
// to nearest, ties away; 11 significant bits) and lo = tf32(a - hi):
// gamma once a block, x^2 (rounded to float32 first) at its staging, u in
// P1's epilogue; shared memory holds the (hi, lo) pairs, not the float32
// operand, so no fragment load splits. a b = a_hi b_hi + a_hi b_lo +
// a_lo b_hi leaves out a_lo b_lo and the splits' residues, ~3 2^-22 |a b|
// a product; each k step adds the small terms first (a_lo b_hi, a_hi
// b_lo), then a_hi b_hi, into the float32 accumulator, as CUTLASS's
// fast-f32 MMA does. One TF32 pass rounds each product at up to 2^-11
// (4.9e-4), above the 1e-4 relative gate the kernel is held to; the JAX
// package's TPU kernel takes its products at XLA's default precision,
// one bf16 pass on the MXU. At a third of the TF32 rate (495 / 3 TFLOP/s)
// the products take 2.5x less than on the CUDA cores, the rgb step's
// C = 50 shapes become bound by bytes, and the step's bound falls from
// 0.62 to 0.36 ms (chip_smoke.gdn_backward_tc_bound). That bound takes
// the data sheet's TF32 rate, which wgmma reaches; mma.sync, at one warp's
// 16 x 8 x 8 a time, reaches less of it. Shared memory is then the
// constraint: split gamma takes 8 C^2 bytes (C = 168: too much for a
// block, so wider C stay on the CUDA cores), and the tile buffers 24
// bytes a value. What holds the kernel now is its serial phases: a block
// stages a tile, then multiplies, with only the other resident block (C
// <= 63) or none (C 64-127) to cover the loads' latency; the products
// are no longer the larger part of its time (PERF.md).
//
// - gdn_backward_kernel (exact float32 FMAs on the CUDA cores: C below 32
//   at more than 65536 rows, and C above 127): persistent blocks of 256
//   threads, each walking row
//   tiles blockIdx.x, + gridDim.x, ... Once per block gamma is staged into
//   shared memory at a padded stride (or, where it does not fit, read from
//   a padded copy in global memory that gdn_backward_pad_kernel writes).
//   Per tile of tile_rows rows, all C channels of a row in the block:
//   1. the tile's x, g (widened to float32) and x^2 go to shared memory,
//      loaded flat over the tile's contiguous values (every lane used at
//      any C); x^2 carries a column of ones at C (for dbeta), set once;
//   2. P1, n = beta + x^2 gamma^T, in register micro-tiles of kRM rows x 7
//      output channels (a warp 8 kRM rows x 28 channels; float4 loads
//      along the input channels, as csrc/gdn.cu's forward), then u and
//      the first term of dx (g r, or g s) in place of g;
//   3. P2, v = u @ gamma, in micro-tiles of kRM rows x 8 columns (outer
//      products over o: a float4 of u's row, two of gamma's), then
//      dx = g r - x v (IGDN: g s + x v) in place of x;
//   4. P3, the block's partial dgamma and dbeta, [u^T x^2, u^T 1] over
//      the tile's rows, in micro-tiles of 4 x 8 of the C x (C + 1)
//      output (32 x 32 a warp). Where those warp tiles number at most 8
//      (C <= 63: "split"), each is taken by 8 / tiles warps, each summing
//      every 8 / tiles-th row, and the sums stay in registers over all the
//      block's tiles, added up in a fixed order at its end and stored once
//      to the block's slice of the partials; else they are added to the
//      block's slice each tile (in L2: the first tile writes, later ones
//      add);
//   5. dx stored flat over the tile's values, coalesced.
//   Four barriers a tile; the tile buffers are float32 at one row stride
//   (>= the 28-rounded C and C + 1, 4 mod 8 floats, so a warp's 8 rows
//   fall in distinct banks).
// - gdn_backward_sum_kernel: dgamma and dbeta as the -+1/2 scaled sum of the
//   blocks' slices, 8 warps an output group each over every 8th slice,
//   then added in warp order.
// - gdn_backward_mma_kernel (the tensor cores): the same blocks, tiles,
//   barriers and partials, and the same recomputation of n, u and dx. Per
//   block gamma is split into shared memory as (hi, lo) pairs; a tile's
//   x^2 and u likewise, x and g as floats. The three products are warp
//   tiles of m16 x 2 n8 MMA tiles (P1, P2: rows x channels, K = C
//   rounded up to 8; x^2's ones column meets gamma's zero column) and
//   m16 x 4 n8 (8 n8 at 512 threads; P3: o x j', K = the tile's rows, u
//   zero past them), P3's kept in registers over all a block's tiles and
//   stored once, a warp tile a warp (256 threads, two blocks an SM, where
//   they number at most 8: C <= 63; else 512 threads, one block). Warp
//   tiles are fixed in width, the last n8 tile repeated past the edge and
//   its sums dropped, so that no MMA sits under a branch (widths chosen
//   at run time with a guard on each MMA ran 1.6x slower on the card,
//   PERF.md). A fragment reads its
//   (hi, lo) pairs rows by lane group in some products and by lane within
//   a group in others; at a row stride of 4 mod 8 pairs (mma_stride) the
//   16 lanes of a half-warp hit 16 distinct 8-byte bank pairs in both.
// The plan (the path; tile rows, rows per thread, blocks, gamma in shared
// memory or not, the split, threads) is ops/gdn.py:gdn_backward_plan's;
// the partials take blocks x C x pad4(C + 1) floats, which the plan
// bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // the sum's and the padding's blocks
constexpr int kWarps = kThreads / 32;
// the rows kernel's blocks: 256 threads, two blocks an SM; or 512, one an
// SM, where P3's sums are kept by 16 warps (C 64-127)
constexpr int kWide = 512;
constexpr int kCN = 7;         // P1: output channels a thread
constexpr int kWarpCols = 28;  // P1: a warp's channels (4 groups x kCN)
constexpr int kP2Cols = 32;    // P2: a warp's columns (4 groups x 8)
constexpr int kP3 = 32;        // P3: a warp's tile of o x j' is 32 x 32
// Dynamic shared memory a block may use: the H100's 227 KB less 1 KB.
constexpr int kMaxSmem = 227 * 1024 - 1024;
// floats read past the end of gamma's padded rows by P2's last warp
// column (a global copy of gamma carries them; in shared memory the next
// buffer does)
constexpr int kSlack = 32;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int pad4(int c) { return cdiv(c, 4) * 4; }

// gamma's staged rows (P1's output channels): C rounded up to 28
__host__ __device__ constexpr int gamma_rows(int c) {
  return cdiv(c, kWarpCols) * kWarpCols;
}

// Row stride of gamma and of every tile buffer: at least gamma_rows and
// C + 1 (the ones column), 4 mod 8, so that 8 consecutive rows start in
// distinct 16-byte bank groups.
__host__ __device__ constexpr int row_stride(int c) {
  const int s = gamma_rows(c) > pad4(c + 1) ? gamma_rows(c) : pad4(c + 1);
  return (s / 4) % 2 ? s : s + 4;
}

// Floats of one row of a block's partials: dgamma's C columns, dbeta's one,
// rounded up to 4 (float4 stores).
__host__ __device__ constexpr int partial_stride(int c) { return pad4(c + 1); }

// Bytes of shared memory of one block: gamma (if staged), the tiles of
// x^2, u, x (then dx) and g (then g r), and beta. ops/gdn.py:
// gdn_backward_smem_bytes mirrors it.
__host__ __device__ constexpr long long smem_bytes(int c, int tile_rows,
                                                   int smem_gamma) {
  return 4LL * ((smem_gamma ? static_cast<long long>(gamma_rows(c)) *
                                  row_stride(c)
                            : 0LL) +
                4LL * tile_rows * row_stride(c) + gamma_rows(c));
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename E>
__device__ __forceinline__ E narrow(float v);
template <>
__device__ __forceinline__ float narrow<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ float part(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The elementwise parts both rows kernels share. From one value's n, x
// and g: u = g x r^3 (g x / s), returned, and g r (g s) in gr, with r =
// n^-1/2 (GDN) or s = n^1/2 (IGDN).
__device__ __forceinline__ float gdn_u(float nv, float xv, float gv,
                                       bool inverse, float& gr) {
  if (inverse) {
    const float s = sqrtf(nv);
    gr = gv * s;
    return gv * xv / s;
  }
  const float rr = rsqrtf(nv);
  gr = gv * rr;
  return gv * xv * (rr * rr * rr);
}

// dx = g r - x v (g s + x v), from d = g r (g s) and v = (u @ gamma)
__device__ __forceinline__ float gdn_dx(float d, float xv, float v,
                                        bool inverse) {
  return inverse ? d + xv * v : d - xv * v;
}

// The tile's rows x c values (contiguous in global memory) into the
// float32 buffers at stride ls: x, g and x^2. Flat over the values, so
// every lane of a load is used at any C; 4 values a thread in flight; the
// row of value e is (e + 1/2) / c in float32, exact for e < 2^18 (a tile
// holds at most 256 x 868). Pad columns of x^2 are set once per block.
template <int kT, typename E>
__device__ __forceinline__ void stage_tile(const E* __restrict__ x,
                                           const E* __restrict__ g,
                                           long long row0, int rows, int c,
                                           float inv_c, int ls, float* xf,
                                           float* gf, float* x2, int tid) {
  const long long base = row0 * c;
  const int count = rows * c;
  for (int e0 = tid; e0 < count; e0 += 4 * kT) {
    float xv[4], gv[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kT;
      xv[k] = e < count ? widen(x[base + e]) : 0.f;
      gv[k] = e < count ? widen(g[base + e]) : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kT;
      if (e >= count) break;
      const int r = static_cast<int>((e + 0.5f) * inv_c);
      const int at = r * ls + e - r * c;
      xf[at] = xv[k];
      gf[at] = gv[k];
      x2[at] = xv[k] * xv[k];
    }
  }
}

// Grid (blocks); kT threads (256 or kWide). E: x's, g's and dx's type.
// kRM: rows per thread of P1 and P2. kSmemGamma: gamma staged in shared
// memory, else read from gamma_pad (gamma_rows(c) x row_stride(c) floats
// and kSlack, zero past C). partial: blocks x c x partial_stride(c)
// floats, a slice a block. kKeep false (split 0): P3's sums added to the
// block's slice each tile; true: P3's warp tiles number at most kT / 32 /
// split, each taken by `split` warps (warp s of them sums rows s, s +
// split, ...) whose sums stay in registers over all the block's tiles; at
// the end the block adds them up through shared memory, phase 0 first,
// and stores the block's slice once.
template <typename E, int kRM, bool kSmemGamma, bool kKeep, int kT>
__global__ void __launch_bounds__(kT, 2 * kThreads / kT)
gdn_backward_kernel(const E* __restrict__ x, const E* __restrict__ g,
                    const float* __restrict__ gamma,
                    const float* __restrict__ beta,
                    const float* __restrict__ gamma_pad, E* __restrict__ dx,
                    float* __restrict__ partial, int n, int c, int tile_rows,
                    int split, int inverse) {
  constexpr int kWarpRows = 8 * kRM;
  constexpr int kW = kT / 32;  // warps
  const int ls = row_stride(c), grows = gamma_rows(c);
  const int ps = partial_stride(c), c4 = pad4(c) / 4, q = ls / 4;
  const int tr = tile_rows;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  // gamma (if staged), then x^2, u, x, g, beta: a read past the end of
  // gamma's rows or of a row of x^2 or u lands in the next buffer
  float* g_s = smem;
  float* x2_s = smem + (kSmemGamma ? grows * ls : 0);
  float* u_s = x2_s + tr * ls;
  float* xf_s = u_s + tr * ls;
  float* gf_s = xf_s + tr * ls;
  float* b_s = gf_s + tr * ls;
  const float* G;
  if constexpr (kSmemGamma) {
    G = g_s;
  } else {
    G = gamma_pad;
  }

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int tiles = (n + tr - 1) / tr;
  const float inv_c = 1.f / c;
  float* slice = partial + static_cast<long long>(blockIdx.x) * c * ps;

  if constexpr (kSmemGamma) {
    // gamma at the padded stride: its C x C values flat, 4 loads a thread
    // in flight, then zeros past C
    for (int e0 = tid; e0 < c * c; e0 += 4 * kT) {
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kT;
        v[k] = e < c * c ? gamma[e] : 0.f;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int e = e0 + k * kT;
        if (e >= c * c) break;
        const int o = static_cast<int>((e + 0.5f) * inv_c);
        g_s[o * ls + e - o * c] = v[k];
      }
    }
    for (int i = tid; i < grows * ls; i += kT) {
      const int o = i / ls, j = i - o * ls;
      if (o >= c || j >= c) g_s[i] = 0.f;
    }
  }
  // beta; 1 past C (those channels' (r)sqrt stays finite and unused)
  for (int o = tid; o < grows; o += kT) b_s[o] = o < c ? beta[o] : 1.f;
  // x^2's columns past C: a 1 at C (dbeta's column), zeros after. Staging
  // writes only the first C, and no phase reads x^2 past a tile's real
  // rows but P1, whose outputs there are not used; x's and g's pad
  // columns are never read.
  for (int i = tid; i < tr * (ls - c); i += kT) {
    const int r = i / (ls - c), j = c + i - r * (ls - c);
    x2_s[r * ls + j] = j == c ? 1.f : 0.f;
  }

  const int rg = lane & 7, cg = lane >> 3;  // P1, P2: row and column groups
  const int wrows = tr / kWarpRows;
  const int wcols1 = grows / kWarpCols, wcols2 = cdiv(c, kP2Cols);
  const int o_tiles = cdiv(c, kP3), j_tiles = cdiv(c + 1, kP3);
  const int lo = lane >> 2, lj = lane & 3;  // P3: o and j' groups
  // kKeep: this warp's P3 warp tile and its rows' phase, its sums
  const int p3_tile = kKeep ? warp / split : 0;
  const int p3_phase = kKeep ? warp - p3_tile * split : 0;
  const bool p3_warp = kKeep && p3_tile < o_tiles * j_tiles;
  float acc3[4][8];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc3[a][b] = 0.f;

  bool first = true;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x, first = false) {
    const long long row0 = static_cast<long long>(t) * tr;
    const int rows = static_cast<int>(n - row0 < tr ? n - row0 : tr);
    __syncthreads();  // the last tile's dx is stored; gamma is staged
    stage_tile<kT>(x, g, row0, rows, c, inv_c, ls, xf_s, gf_s, x2_s, tid);
    __syncthreads();

    // P1: n = beta + x^2 gamma^T; then u, and g r (g s) in place of g
    for (int wt = warp; wt < wrows * wcols1; wt += kW) {
      const int wr = wt / wcols1, wc = wt - wr * wcols1;
      const int r_base = wr * kWarpRows + rg;  // rows r_base + 8i
      const int o_base = wc * kWarpCols + cg;  // channels o_base + 4k
      float acc[kRM][kCN];
#pragma unroll
      for (int k = 0; k < kCN; ++k) {
        const float bv = b_s[o_base + 4 * k];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][k] = bv;
      }
      const float4* x4 = reinterpret_cast<const float4*>(x2_s + r_base * ls);
      const float4* g4 = reinterpret_cast<const float4*>(G + o_base * ls);
#pragma unroll 2
      for (int j4 = 0; j4 < c4; ++j4) {
        float4 gv[kCN];
#pragma unroll
        for (int k = 0; k < kCN; ++k) gv[k] = g4[4 * k * q + j4];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float4 xv = x4[8 * i * q + j4];
#pragma unroll
          for (int k = 0; k < kCN; ++k) {
            acc[i][k] = fmaf(gv[k].x, xv.x, acc[i][k]);
            acc[i][k] = fmaf(gv[k].y, xv.y, acc[i][k]);
            acc[i][k] = fmaf(gv[k].z, xv.z, acc[i][k]);
            acc[i][k] = fmaf(gv[k].w, xv.w, acc[i][k]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = r_base + 8 * i;
#pragma unroll
        for (int k = 0; k < kCN; ++k) {
          const int o = o_base + 4 * k;
          float uo = 0.f;  // zero past C and past the real rows
          if (r < rows && o < c) {
            // this thread alone reads and writes (r, o) of x and g here
            const float xv = xf_s[r * ls + o], gv = gf_s[r * ls + o];
            uo = gdn_u(acc[i][k], xv, gv, inverse, gf_s[r * ls + o]);
          }
          u_s[r * ls + o] = uo;
        }
      }
    }
    __syncthreads();  // u and g r (g s) complete

    // P2: v = u @ gamma; dx = g r - x v (g s + x v) in place of x
    for (int wt = warp; wt < wrows * wcols2; wt += kW) {
      const int wr = wt / wcols2, wc = wt - wr * wcols2;
      const int r_base = wr * kWarpRows + rg;  // rows r_base + 8i
      const int j_base = wc * kP2Cols + 8 * cg;  // columns j_base + 0..7
      float acc[kRM][8];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
#pragma unroll 2
      for (int o4 = 0; o4 < c4; ++o4) {
        float4 uv[kRM];
#pragma unroll
        for (int i = 0; i < kRM; ++i)
          uv[i] = *reinterpret_cast<const float4*>(
              u_s + (r_base + 8 * i) * ls + 4 * o4);
#pragma unroll
        for (int qq = 0; qq < 4; ++qq) {
          const float* grow = G + (4 * o4 + qq) * ls + j_base;
          const float4 ga = *reinterpret_cast<const float4*>(grow);
          const float4 gb = *reinterpret_cast<const float4*>(grow + 4);
#pragma unroll
          for (int i = 0; i < kRM; ++i) {
            const float uq = part(uv[i], qq);
            acc[i][0] = fmaf(uq, ga.x, acc[i][0]);
            acc[i][1] = fmaf(uq, ga.y, acc[i][1]);
            acc[i][2] = fmaf(uq, ga.z, acc[i][2]);
            acc[i][3] = fmaf(uq, ga.w, acc[i][3]);
            acc[i][4] = fmaf(uq, gb.x, acc[i][4]);
            acc[i][5] = fmaf(uq, gb.y, acc[i][5]);
            acc[i][6] = fmaf(uq, gb.z, acc[i][6]);
            acc[i][7] = fmaf(uq, gb.w, acc[i][7]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = r_base + 8 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int j = j_base + jj;
          if (j >= c) continue;
          xf_s[r * ls + j] = gdn_dx(gf_s[r * ls + j], xf_s[r * ls + j],
                                    acc[i][jj], inverse);
        }
      }
    }

    // P3, kKeep: this warp's sums += [u^T x^2, u^T 1] over its rows of
    // the tile
    if constexpr (kKeep) {
      if (p3_warp) {
        const int ot = p3_tile / j_tiles, jt = p3_tile - ot * j_tiles;
        const int o0 = ot * kP3 + 4 * lo, j0 = jt * kP3 + 8 * lj;
        for (int r = p3_phase; r < rows; r += split) {
          const float4 uv =
              *reinterpret_cast<const float4*>(u_s + r * ls + o0);
          const float4 xa =
              *reinterpret_cast<const float4*>(x2_s + r * ls + j0);
          const float4 xb =
              *reinterpret_cast<const float4*>(x2_s + r * ls + j0 + 4);
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            const float ua = part(uv, a);
            acc3[a][0] = fmaf(ua, xa.x, acc3[a][0]);
            acc3[a][1] = fmaf(ua, xa.y, acc3[a][1]);
            acc3[a][2] = fmaf(ua, xa.z, acc3[a][2]);
            acc3[a][3] = fmaf(ua, xa.w, acc3[a][3]);
            acc3[a][4] = fmaf(ua, xb.x, acc3[a][4]);
            acc3[a][5] = fmaf(ua, xb.y, acc3[a][5]);
            acc3[a][6] = fmaf(ua, xb.z, acc3[a][6]);
            acc3[a][7] = fmaf(ua, xb.w, acc3[a][7]);
          }
        }
      }
    }
    // P3, else: the block's partials += [u^T x^2, u^T 1] over the tile's
    // rows
    for (int wt = warp; !kKeep && wt < o_tiles * j_tiles; wt += kW) {
      const int ot = wt / j_tiles, jt = wt - ot * j_tiles;
      const int o0 = ot * kP3 + 4 * lo, j0 = jt * kP3 + 8 * lj;
      float acc[4][8];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
      for (int r = 0; r < rows; ++r) {
        const float4 uv = *reinterpret_cast<const float4*>(u_s + r * ls + o0);
        const float4 xa = *reinterpret_cast<const float4*>(x2_s + r * ls + j0);
        const float4 xb =
            *reinterpret_cast<const float4*>(x2_s + r * ls + j0 + 4);
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const float ua = part(uv, a);
          acc[a][0] = fmaf(ua, xa.x, acc[a][0]);
          acc[a][1] = fmaf(ua, xa.y, acc[a][1]);
          acc[a][2] = fmaf(ua, xa.z, acc[a][2]);
          acc[a][3] = fmaf(ua, xa.w, acc[a][3]);
          acc[a][4] = fmaf(ua, xb.x, acc[a][4]);
          acc[a][5] = fmaf(ua, xb.y, acc[a][5]);
          acc[a][6] = fmaf(ua, xb.z, acc[a][6]);
          acc[a][7] = fmaf(ua, xb.w, acc[a][7]);
        }
      }
      // columns past C + 1 within the padded row are written, never read
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int o = o0 + a;
        if (o >= c) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int j = j0 + 4 * h;
          if (j >= ps) continue;
          float4* p = reinterpret_cast<float4*>(
              slice + static_cast<long long>(o) * ps + j);
          float4 v = make_float4(acc[a][4 * h], acc[a][4 * h + 1],
                                 acc[a][4 * h + 2], acc[a][4 * h + 3]);
          if (!first) {
            const float4 old = *p;
            v.x += old.x;
            v.y += old.y;
            v.z += old.z;
            v.w += old.w;
          }
          *p = v;
        }
      }
    }
    __syncthreads();  // dx complete in the x tile

    // coalesced stores of dx, flat over the tile's values; the one
    // rounding to E
    for (int e = tid; e < rows * c; e += kT) {
      const int r = static_cast<int>((e + 0.5f) * inv_c);
      dx[row0 * c + e] = narrow<E>(xf_s[r * ls + e - r * c]);
    }
  }
  if constexpr (kKeep) {
    // the phases' sums of each warp tile added up in phase order through
    // the tile buffers (free now): 1024 floats a warp tile
    float* sums_s = x2_s + p3_tile * 1024 + lane * 32;
    for (int ph = 1; ph < split; ++ph) {
      __syncthreads();
      if (p3_warp && p3_phase == ph) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) sums_s[a * 8 + b] = acc3[a][b];
      }
      __syncthreads();
      if (p3_warp && p3_phase == 0) {
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int b = 0; b < 8; ++b) acc3[a][b] += sums_s[a * 8 + b];
      }
    }
    // the block's slice, stored once by phase 0's warps
    if (p3_warp && p3_phase == 0) {
      float* own = slice;
      const int ot = p3_tile / j_tiles, jt = p3_tile - ot * j_tiles;
      const int o0 = ot * kP3 + 4 * lo, j0 = jt * kP3 + 8 * lj;
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        if (o0 + a >= c) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (j0 + 4 * h >= ps) continue;
          *reinterpret_cast<float4*>(own +
                                     static_cast<long long>(o0 + a) * ps +
                                     j0 + 4 * h) =
              make_float4(acc3[a][4 * h], acc3[a][4 * h + 1],
                          acc3[a][4 * h + 2], acc3[a][4 * h + 3]);
        }
      }
    }
  }
}

// --- the tensor-core path: P1, P2 and P3 in 3xTF32 on mma.sync ---------

constexpr int kMmaNt = 2;  // P1, P2: n8 tiles of a warp tile

__host__ __device__ constexpr int mma_c8(int c) { return cdiv(c, 8) * 8; }
// P3's tiles: m16 over o (u's columns), n8 over j' (x^2's and the ones)
__host__ __device__ constexpr int mma_m3(int c) { return cdiv(c, 16); }
__host__ __device__ constexpr int mma_n3(int c) { return cdiv(c + 1, 8); }

// (hi, lo) pairs a row of gamma, x^2 and u: every column a product reads
// (C rounded up to 8, P3's 16 m3 and 8 n3), 4 mod 8. A fragment's 8-byte
// loads are served a half-warp at a time, and a half-warp's 16 lanes read
// a 4 x 4 block: rows by lane group and columns by lane in a group (A,
// and B as P1's gamma^T), or the other way round (B as P2's gamma and
// P3's x^2, A as P3's u^T). At a stride of 4 mod 8 pairs both fall in 16
// distinct 8-byte bank pairs.
__host__ __device__ constexpr int mma_stride(int c) {
  return (16 * mma_m3(c) > 8 * mma_n3(c) ? 16 * mma_m3(c) : 8 * mma_n3(c)) +
         4;
}
// floats a row of x and g: C rounded up to 8, 8 mod 16, so that the
// epilogues' float2 reads of 4 rows fall in distinct banks
__host__ __device__ constexpr int mma_fstride(int c) {
  return mma_c8(c) % 16 ? mma_c8(c) : mma_c8(c) + 8;
}

// Bytes of shared memory of one block: gamma (C8 rows), x^2 and u as
// (hi, lo) pairs, x and g as floats, beta. ops/gdn.py:
// gdn_backward_smem_bytes(..., mma=True) mirrors it.
__host__ __device__ constexpr long long mma_smem_bytes(int c, int tile_rows) {
  return 8LL * mma_c8(c) * mma_stride(c) +
         16LL * tile_rows * mma_stride(c) +
         8LL * tile_rows * mma_fstride(c) + 4LL * mma_c8(c);
}

// P3's n8 tiles of a warp tile (one m16 tile by them): 4 in a block of
// kThreads, 8 in one of kWide
__host__ __device__ constexpr int mma_p3_nt(int threads) {
  return threads == kWide ? 8 : 4;
}

// Whether P3's warp tiles, one a warp, fit the block's warps.
__host__ __device__ constexpr bool mma_p3_fits(int c, int threads) {
  return mma_m3(c) * cdiv(mma_n3(c), mma_p3_nt(threads)) <= threads / 32;
}

// v rounded to TF32 (cvt.rna: to nearest, ties away from zero), the low
// 13 bits clear
__device__ __forceinline__ float tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r & 0xffffe000u);
}

// (hi, lo): hi = tf32(v), lo = tf32(v - hi) (v - hi is exact)
__device__ __forceinline__ float2 split_tf32(float v) {
  const float hi = tf32(v);
  return make_float2(hi, tf32(__fsub_rn(v, hi)));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d[q] += a b[q] for every q < kN in 3xTF32: the small terms first, then
// hi x hi, each term over every q in turn so that consecutive MMAs feed
// distinct accumulators. No MMA sits under a branch.
template <int kN>
__device__ __forceinline__ void mma3(float (&d)[kN][4],
                                     const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[kN][2],
                                     const uint32_t (&bl)[kN][2]) {
#pragma unroll
  for (int q = 0; q < kN; ++q) mma_tf32(d[q], al, bh[q]);
#pragma unroll
  for (int q = 0; q < kN; ++q) mma_tf32(d[q], ah, bl[q]);
#pragma unroll
  for (int q = 0; q < kN; ++q) mma_tf32(d[q], ah, bh[q]);
}

__device__ __forceinline__ void unpack(const float2 (&v)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    hi[i] = __float_as_uint(v[i].x);
    lo[i] = __float_as_uint(v[i].y);
  }
}

// A's fragment (m16 x k8) where A(m, k) = buf[r0 + m][k0 + k] (P1's x^2,
// P2's u): a0 (gid, tig), a1 (gid + 8, tig), a2 (gid, tig + 4), a3
// (gid + 8, tig + 4)
__device__ __forceinline__ void frag_a(const float2* buf, int ls, int r0,
                                       int k0, int gid, int tig,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 v[4] = {buf[(r0 + gid) * ls + k0 + tig],
                       buf[(r0 + gid + 8) * ls + k0 + tig],
                       buf[(r0 + gid) * ls + k0 + tig + 4],
                       buf[(r0 + gid + 8) * ls + k0 + tig + 4]};
  unpack(v, hi, lo);
}

// A's fragment where A(m, k) = buf[k0 + k][m0 + m] (P3's u^T)
__device__ __forceinline__ void frag_at(const float2* buf, int ls, int m0,
                                        int k0, int gid, int tig,
                                        uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  const float2 v[4] = {buf[(k0 + tig) * ls + m0 + gid],
                       buf[(k0 + tig) * ls + m0 + gid + 8],
                       buf[(k0 + tig + 4) * ls + m0 + gid],
                       buf[(k0 + tig + 4) * ls + m0 + gid + 8]};
  unpack(v, hi, lo);
}

// B's fragment (k8 x n8): b0 (k tig, n gid), b1 (k tig + 4, n gid);
// B(k, n) = buf[n0 + n][k0 + k] (P1's gamma^T) where kTrans, else
// buf[k0 + k][n0 + n] (P2's gamma, P3's x^2)
template <bool kTrans>
__device__ __forceinline__ void frag_b(const float2* buf, int ls, int k0,
                                       int n0, int gid, int tig,
                                       uint32_t (&hi)[2], uint32_t (&lo)[2]) {
  const float2 v0 = kTrans ? buf[(n0 + gid) * ls + k0 + tig]
                           : buf[(k0 + tig) * ls + n0 + gid];
  const float2 v1 = kTrans ? buf[(n0 + gid) * ls + k0 + tig + 4]
                           : buf[(k0 + tig + 4) * ls + n0 + gid];
  hi[0] = __float_as_uint(v0.x);
  hi[1] = __float_as_uint(v1.x);
  lo[0] = __float_as_uint(v0.y);
  lo[1] = __float_as_uint(v1.y);
}

// The rows kernel with its three products on the tensor cores. Grid
// (blocks); kT threads (256, two blocks an SM, or 512, one). Per block:
// gamma split once into (hi, lo) pairs at [o][j] (C8 rows, zero
// past C), beta, x^2's ones column and u's columns past C8 (zero). Per
// tile (a multiple of 16 rows): staged flat as stage_tile (x, g as
// floats; x^2 rounded to float32, then split); P1 over m16 x n8 warp
// tiles of the tile's rows x C8 channels, K = C8 (x^2's column C meets
// gamma's zero column), then u (split) and g r (g s) as the CUDA-core
// path; P2 likewise, v = u @ gamma, then dx in place of x; P3's warp w <
// m3 x ceil(n3 / kP3N) keeps the sums of its m16 x (kP3N n8) tile of
// [u^T x^2, u^T 1] in registers over the block's tiles (K: the tile's rows
// rounded up to 8: u is zero past the real rows, x^2 finite) and stores
// them once to the block's slice at its end. The four barriers a tile of
// the CUDA-core path.
template <typename E, int kT>
__global__ void __launch_bounds__(kT, 2 * kThreads / kT)
gdn_backward_mma_kernel(const E* __restrict__ x, const E* __restrict__ g,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta, E* __restrict__ dx,
                        float* __restrict__ partial, int n, int c,
                        int tile_rows, int inverse) {
  constexpr int kW = kT / 32;
  const int ls = mma_stride(c), lf = mma_fstride(c), c8 = mma_c8(c);
  const int ps = partial_stride(c), tr = tile_rows;
  extern __shared__ float4 smem4[];
  float2* g2 = reinterpret_cast<float2*>(smem4);
  float2* x2 = g2 + c8 * ls;
  float2* u2 = x2 + tr * ls;
  float* xf = reinterpret_cast<float*>(u2 + tr * ls);
  float* gf = xf + tr * lf;
  float* b_s = gf + tr * lf;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int tiles = (n + tr - 1) / tr;
  const float inv_c = 1.f / c;
  float* slice = partial + static_cast<long long>(blockIdx.x) * c * ps;

  // gamma, split once: its C x C values flat, 4 loads a thread in flight
  for (int e0 = tid; e0 < c * c; e0 += 4 * kT) {
    float v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kT;
      v[k] = e < c * c ? gamma[e] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = e0 + k * kT;
      if (e >= c * c) break;
      const int o = static_cast<int>((e + 0.5f) * inv_c);
      g2[(o) * ls + e - o * c] = split_tf32(v[k]);
    }
  }
  for (int i = tid; i < c8 * ls; i += kT) {
    const int o = i / ls, j = i - o * ls;
    if (o >= c || j >= c) g2[i] = make_float2(0.f, 0.f);
  }
  for (int o = tid; o < c8; o += kT) b_s[o] = o < c ? beta[o] : 1.f;
  // x^2: a 1 at column C (dbeta's), zeros until staged (rows past a
  // ragged tile's stay finite: zeros or an earlier tile's); u: zeros past
  // C8, which P1 never writes
  for (int i = tid; i < tr * ls; i += kT) {
    const int r = i / ls, j = i - r * ls;
    x2[i] = make_float2(j == c ? 1.f : 0.f, 0.f);
    if (j >= c8) u2[i] = make_float2(0.f, 0.f);
  }

  // P1's and P2's warp tiles: an m16 tile of rows by kMmaNt n8 tiles,
  // ngr of them across C8, the last n8 tile repeated past C8 (its sums are
  // not used); P3's warp w < m3 x ng3: an m16 tile of o by kP3N n8 tiles
  // of j', likewise
  constexpr int kP3N = mma_p3_nt(kT);
  const int m16 = tr / 16, n8 = c8 / 8, ngr = cdiv(n8, kMmaNt);
  const int n3 = mma_n3(c), ng3 = cdiv(n3, kP3N);
  const bool p3_warp = warp < mma_m3(c) * ng3;
  const int p3_m0 = warp / ng3 * 16, p3_nb = warp % ng3 * kP3N;
  float acc3[kP3N][4];
#pragma unroll
  for (int q = 0; q < kP3N; ++q)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc3[q][i] = 0.f;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long row0 = static_cast<long long>(t) * tr;
    const int rows = static_cast<int>(n - row0 < tr ? n - row0 : tr);
    __syncthreads();  // the last tile's dx is stored; gamma is staged
    {
      const long long base = row0 * c;
      const int count = rows * c;
      for (int e0 = tid; e0 < count; e0 += 4 * kT) {
        float xv[4], gv[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kT;
          xv[k] = e < count ? widen(x[base + e]) : 0.f;
          gv[k] = e < count ? widen(g[base + e]) : 0.f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = e0 + k * kT;
          if (e >= count) break;
          const int r = static_cast<int>((e + 0.5f) * inv_c), j = e - r * c;
          xf[r * lf + j] = xv[k];
          gf[r * lf + j] = gv[k];
          x2[(r) * ls + j] = split_tf32(__fmul_rn(xv[k], xv[k]));
        }
      }
    }
    __syncthreads();

    // P1: n = beta + x^2 gamma^T; then u (split), and g r (g s) in place
    // of g
    for (int wt = warp; wt < m16 * ngr; wt += kW) {
      const int r0 = wt / ngr * 16, nb = wt % ngr * kMmaNt;
      int n0[kMmaNt];
      float acc[kMmaNt][4];
#pragma unroll
      for (int q = 0; q < kMmaNt; ++q) {
        n0[q] = (nb + q < n8 ? nb + q : n8 - 1) * 8;
        acc[q][0] = acc[q][2] = b_s[n0[q] + 2 * tig];
        acc[q][1] = acc[q][3] = b_s[n0[q] + 2 * tig + 1];
      }
      for (int k0 = 0; k0 < c8; k0 += 8) {
        uint32_t ah[4], al[4], bh[kMmaNt][2], bl[kMmaNt][2];
        frag_a(x2, ls, r0, k0, gid, tig, ah, al);
#pragma unroll
        for (int q = 0; q < kMmaNt; ++q)
          frag_b<true>(g2, ls, k0, n0[q], gid, tig, bh[q], bl[q]);
        mma3(acc, ah, al, bh, bl);
      }
      // the accumulators' channel pairs (o, o + 1), a float2 of x and g
      // each (this thread alone reads and writes them here), a float4 of
      // u's two (hi, lo) pairs; u is zero past C and past the real rows,
      // and g's pad columns take what is computed there, never read
#pragma unroll
      for (int q = 0; q < kMmaNt; ++q) {
        if (nb + q >= n8) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + gid + 8 * h, o = n0[q] + 2 * tig;
          float uo[2] = {0.f, 0.f};
          if (r < rows) {
            float2* xp = reinterpret_cast<float2*>(xf + r * lf + o);
            float2* gp = reinterpret_cast<float2*>(gf + r * lf + o);
            const float2 xv = *xp, gv = *gp;
            float d[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              uo[e] = gdn_u(acc[q][2 * h + e], e ? xv.y : xv.x,
                            e ? gv.y : gv.x, inverse, d[e]);
              if (o + e >= c) uo[e] = 0.f;
            }
            *gp = make_float2(d[0], d[1]);
          }
          const float2 u0 = split_tf32(uo[0]), u1 = split_tf32(uo[1]);
          *reinterpret_cast<float4*>(u2 + r * ls + o) =
              make_float4(u0.x, u0.y, u1.x, u1.y);
        }
      }
    }
    __syncthreads();  // u and g r (g s) complete

    // P2: v = u @ gamma; dx = g r - x v (g s + x v) in place of x
    for (int wt = warp; wt < m16 * ngr; wt += kW) {
      const int r0 = wt / ngr * 16, nb = wt % ngr * kMmaNt;
      int n0[kMmaNt];
      float acc[kMmaNt][4];
#pragma unroll
      for (int q = 0; q < kMmaNt; ++q) {
        n0[q] = (nb + q < n8 ? nb + q : n8 - 1) * 8;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[q][i] = 0.f;
      }
      for (int k0 = 0; k0 < c8; k0 += 8) {
        uint32_t ah[4], al[4], bh[kMmaNt][2], bl[kMmaNt][2];
        frag_a(u2, ls, r0, k0, gid, tig, ah, al);
#pragma unroll
        for (int q = 0; q < kMmaNt; ++q)
          frag_b<false>(g2, ls, k0, n0[q], gid, tig, bh[q], bl[q]);
        mma3(acc, ah, al, bh, bl);
      }
      // channel pairs (j, j + 1) as float2s; x's pad columns take what
      // is computed there, never read
#pragma unroll
      for (int q = 0; q < kMmaNt; ++q) {
        if (nb + q >= n8) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + gid + 8 * h, j = n0[q] + 2 * tig;
          if (r >= rows) continue;
          float2* xp = reinterpret_cast<float2*>(xf + r * lf + j);
          const float2 xv = *xp;
          const float2 d = *reinterpret_cast<const float2*>(gf + r * lf + j);
          *xp = make_float2(gdn_dx(d.x, xv.x, acc[q][2 * h], inverse),
                            gdn_dx(d.y, xv.y, acc[q][2 * h + 1], inverse));
        }
      }
    }

    // P3: this warp's sums += [u^T x^2, u^T 1] over the tile's rows
    if (p3_warp) {
      const int kr = cdiv(rows, 8) * 8;
      for (int k0 = 0; k0 < kr; k0 += 8) {
        uint32_t ah[4], al[4];
        frag_at(u2, ls, p3_m0, k0, gid, tig, ah, al);
#pragma unroll
        for (int h = 0; h < kP3N; h += 4) {
          uint32_t bh[4][2], bl[4][2];
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int nt = p3_nb + h + q < n3 ? p3_nb + h + q : n3 - 1;
            frag_b<false>(x2, ls, k0, nt * 8, gid, tig, bh[q], bl[q]);
          }
          mma3(reinterpret_cast<float(&)[4][4]>(acc3[h]), ah, al, bh, bl);
        }
      }
    }
    __syncthreads();  // dx complete in the x tile

    // coalesced stores of dx, flat over the tile's values; the one
    // rounding to E
    for (int e = tid; e < rows * c; e += kT) {
      const int r = static_cast<int>((e + 0.5f) * inv_c);
      dx[row0 * c + e] = narrow<E>(xf[r * lf + e - r * c]);
    }
  }
  // the block's slice, stored once; columns past C + 1 within the padded
  // row are written, never read
  if (p3_warp) {
#pragma unroll
    for (int q = 0; q < kP3N; ++q) {
      if (p3_nb + q >= n3) continue;
      const int j = (p3_nb + q) * 8 + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = p3_m0 + gid + 8 * h;
        if (o < c && j < ps)
          *reinterpret_cast<float2*>(slice + static_cast<long long>(o) * ps +
                                     j) =
              make_float2(acc3[q][2 * h], acc3[q][2 * h + 1]);
      }
    }
  }
}

// gamma (C x C) into gamma_rows(c) x row_stride(c) floats and kSlack, zero
// past C: the copy gdn_backward_kernel reads where gamma does not fit in
// shared memory.
__global__ void gdn_backward_pad_kernel(const float* __restrict__ gamma,
                                        int c, float* __restrict__ gamma_pad) {
  const int ls = row_stride(c);
  const long long total =
      static_cast<long long>(gamma_rows(c)) * ls + kSlack;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < total; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long o = i / ls, j = i - o * ls;
    gamma_pad[i] = o < c && j < c ? gamma[o * c + j] : 0.f;
  }
}

// dgamma[o, j] = scale * sum_b partial[b, o, j], dbeta[o] = scale * sum_b
// partial[b, o, c] over the `slices` slices. A block of kThreads takes 32
// outputs (consecutive, so a warp's loads are coalesced); its warp w sums
// slices w, w + kWarps, ... of them, and warp 0 adds the kWarps sums in
// warp order: a fixed order at any scheduling.
__global__ void __launch_bounds__(kThreads)
gdn_backward_sum_kernel(const float* __restrict__ partial, int slices,
                        int c, float scale, float* __restrict__ dgamma,
                        float* __restrict__ dbeta) {
  __shared__ float sums_s[kWarps][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int i = blockIdx.x * 32 + lane;
  const int total = c * (c + 1);
  const int o = i / (c + 1), j = i - o * (c + 1);
  float s = 0.f;
  if (i < total) {
    const long long slice = static_cast<long long>(c) * partial_stride(c);
    const float* p =
        partial + static_cast<long long>(o) * partial_stride(c) + j;
#pragma unroll 4
    for (int b = warp; b < slices; b += kWarps) s += p[b * slice];
  }
  sums_s[warp][lane] = s;
  __syncthreads();
  if (warp != 0 || i >= total) return;
  for (int w = 1; w < kWarps; ++w) s += sums_s[w][lane];
  if (j < c)
    dgamma[o * c + j] = scale * s;
  else
    dbeta[o] = scale * s;
}

// cudaFuncSetAttribute once per instantiation (and process: the port runs
// on one card), not on every launch.
template <typename E, int kRM, bool kSmemGamma, bool kKeep, int kT>
cudaError_t ready() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gdn_backward_kernel<E, kRM, kSmemGamma, kKeep, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  return err;
}

struct Launch {
  const void* x;
  const void* g;
  const float* gamma;
  const float* beta;
  const float* gamma_pad;
  void* dx;
  float* partial;
  int n, c, tile_rows, blocks, split, inverse;
  cudaStream_t st;
  size_t smem;
};

template <typename E, int kRM, bool kSmemGamma, bool kKeep,
          int kT = kThreads>
int launch_rows(const Launch& a) {
  const cudaError_t err = ready<E, kRM, kSmemGamma, kKeep, kT>();
  if (err != cudaSuccess) return static_cast<int>(err);
  gdn_backward_kernel<E, kRM, kSmemGamma, kKeep, kT>
      <<<a.blocks, kT, a.smem, a.st>>>(
          static_cast<const E*>(a.x), static_cast<const E*>(a.g), a.gamma,
          a.beta, a.gamma_pad, static_cast<E*>(a.dx), a.partial, a.n, a.c,
          a.tile_rows, a.split, a.inverse);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int kT>
int launch_mma(const Launch& a) {
  static const cudaError_t ready = cudaFuncSetAttribute(
      gdn_backward_mma_kernel<E, kT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (ready != cudaSuccess) return static_cast<int>(ready);
  gdn_backward_mma_kernel<E, kT><<<a.blocks, kT, a.smem, a.st>>>(
      static_cast<const E*>(a.x), static_cast<const E*>(a.g), a.gamma, a.beta,
      static_cast<E*>(a.dx), a.partial, a.n, a.c, a.tile_rows, a.inverse);
  return static_cast<int>(cudaGetLastError());
}

// The instantiations: 4 or 2 rows a thread, gamma in shared or global
// memory, P3 added to the partials each tile; and P3 kept in registers
// with 2 rows a thread and gamma in shared memory, by 256 threads (C <=
// 63) or kWide (C 64-127).
template <typename E>
int launch_type(const Launch& a, int rm, int smem_gamma, int threads,
                int mma) {
  if (mma)
    return threads == kWide ? launch_mma<E, kWide>(a)
                            : launch_mma<E, kThreads>(a);
  if (a.split)
    return threads == kWide ? launch_rows<E, 2, true, true, kWide>(a)
                            : launch_rows<E, 2, true, true>(a);
  if (rm == 4)
    return smem_gamma ? launch_rows<E, 4, true, false>(a)
                      : launch_rows<E, 4, false, false>(a);
  return smem_gamma ? launch_rows<E, 2, true, false>(a)
                    : launch_rows<E, 2, false, false>(a);
}

}  // namespace

// x, g, dx: (n, c) row-major, float32, or bfloat16 where bf16 != 0; gamma
// (c, c) and beta (c,) float32; dgamma (c, c) and dbeta (c,) float32
// outputs. partial: blocks x c x pad4(c + 1) floats of scratch;
// gamma_pad: gamma_rows(c) x row_stride(c) + 32 floats of scratch where
// smem_gamma is 0, else unused. n >= 1, c >= 1. The plan
// (ops/gdn.py:gdn_backward_plan): mma 0 (the CUDA-core path) or 1 (the
// tensor cores); blocks >= 1 (at most one per tile); threads 256, or
// kWide. On the CUDA-core path rm (rows per thread) 2 or 4, tile_rows a
// multiple of 8 * rm, smem_gamma 0 or 1, split 0 (P3's sums added to the
// partials each tile) or 1-16 (kept in registers by `split` warps a warp
// tile: rm 2, smem_gamma 1, at most threads / 32 / split of P3's 32 x 32
// warp tiles, whose 1024 floats each fit in the tile buffers), kWide only
// with a split. On the tensor cores rm 2, smem_gamma 1 and split 0,
// tile_rows a multiple of 16, and P3's warp tiles (mma_p3_fits) within the
// block's warps. Launches, on `stream`, the padding of gamma (where
// smem_gamma is 0), the rows kernel and the sum; returns the first failed
// launch's CUDA error (0 on success), or cudaErrorInvalidValue for a plan
// it has no kernel or shared memory for.
extern "C" int mmnc_gdn_backward(const void* x, const void* g,
                                 const float* gamma, const float* beta,
                                 float* gamma_pad, void* dx, float* partial,
                                 float* dgamma, float* dbeta, int n, int c,
                                 int rm, int tile_rows, int blocks,
                                 int smem_gamma, int split, int threads,
                                 int mma, int inverse, int bf16,
                                 void* stream) {
  const long long smem = mma ? mma_smem_bytes(c, tile_rows)
                             : smem_bytes(c, tile_rows, smem_gamma);
  const int p3_tiles = cdiv(c, kP3) * cdiv(c + 1, kP3);
  const int warps = threads / 32;
  if (n < 1 || c < 1 || blocks < 1 || (mma != 0 && mma != 1) ||
      (threads != kThreads && threads != kWide) || smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mma ? (rm != 2 || smem_gamma != 1 || split != 0 || tile_rows < 16 ||
             tile_rows % 16 || !mma_p3_fits(c, threads))
          : ((rm != 2 && rm != 4) || tile_rows < 8 * rm ||
             tile_rows % (8 * rm) ||
             (smem_gamma != 0 && smem_gamma != 1) ||
             (!smem_gamma && gamma_pad == nullptr) ||
             (threads == kWide && !split) || split < 0 || split > warps ||
             (split && (rm != 2 || !smem_gamma || p3_tiles * split > warps ||
                        p3_tiles * 1024 > 4 * tile_rows * row_stride(c)))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (blocks > (n + tile_rows - 1) / tile_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!mma && !smem_gamma) {
    gdn_backward_pad_kernel<<<cdiv(gamma_rows(c) * row_stride(c) + kSlack,
                                   kThreads),
                              kThreads, 0, st>>>(gamma, c, gamma_pad);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Launch a{x,      g,         gamma, beta,   gamma_pad, dx,
                 partial, n,        c,     tile_rows, blocks, split,
                 inverse, st,       static_cast<size_t>(smem)};
  const int rc =
      bf16 ? launch_type<__nv_bfloat16>(a, rm, smem_gamma, threads, mma)
           : launch_type<float>(a, rm, smem_gamma, threads, mma);
  if (rc != 0) return rc;
  gdn_backward_sum_kernel<<<cdiv(c * (c + 1), 32), kThreads, 0, st>>>(
      partial, blocks, c, inverse ? 0.5f : -0.5f, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}
