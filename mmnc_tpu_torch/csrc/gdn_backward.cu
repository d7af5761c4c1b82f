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
// float32) against three C x C products (3 C^2 FMAs): C/2 FLOP per byte,
// so from C = 40 on the CUDA cores' float32 rate (67 TFLOP/s) bounds it,
// not HBM; the path's C = 50 and 100 shapes hold most of its work.
//
// Design (exact float32 FMAs on CUDA cores; no atomics; every sum in a
// fixed order, so two launches on the same inputs are bitwise equal):
// - gdn_backward_kernel: persistent blocks of 256 threads, each walking row
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
// The plan (tile rows, rows per thread, blocks, gamma in shared memory or
// not, the split) is ops/gdn.py:gdn_backward_plan's; the partials take
// blocks x C x pad4(C + 1) floats, which the plan bounds.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
            const float nv = acc[i][k];
            const float xv = xf_s[r * ls + o], gv = gf_s[r * ls + o];
            if (inverse) {
              const float s = sqrtf(nv);
              uo = gv * xv / s;
              gf_s[r * ls + o] = gv * s;
            } else {
              const float rr = rsqrtf(nv);
              uo = gv * xv * (rr * rr * rr);
              gf_s[r * ls + o] = gv * rr;
            }
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
          const float xv = xf_s[r * ls + j], d = gf_s[r * ls + j];
          xf_s[r * ls + j] =
              inverse ? d + xv * acc[i][jj] : d - xv * acc[i][jj];
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

// The instantiations: 4 or 2 rows a thread, gamma in shared or global
// memory, P3 added to the partials each tile; and P3 kept in registers
// with 2 rows a thread and gamma in shared memory, by 256 threads (C <=
// 63) or kWide (C 64-127).
template <typename E>
int launch_type(const Launch& a, int rm, int smem_gamma, int threads) {
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
// (ops/gdn.py:gdn_backward_plan): rm (rows per thread) 2 or 4, tile_rows a
// multiple of 8 * rm, blocks >= 1 (at most one per tile), smem_gamma 0 or
// 1, split 0 (P3's sums added to the partials each tile) or 1-16 (kept in
// registers by `split` warps a warp tile: rm 2, smem_gamma 1, at most
// threads / 32 / split of P3's 32 x 32 warp tiles, whose 1024 floats each
// fit in the tile buffers), threads 256, or kWide with a split. Launches,
// on `stream`, the padding of gamma (where smem_gamma is 0), the rows
// kernel and the sum; returns the first failed launch's CUDA error (0 on
// success), or cudaErrorInvalidValue for a plan it has no kernel or
// shared memory for.
extern "C" int mmnc_gdn_backward(const void* x, const void* g,
                                 const float* gamma, const float* beta,
                                 float* gamma_pad, void* dx, float* partial,
                                 float* dgamma, float* dbeta, int n, int c,
                                 int rm, int tile_rows, int blocks,
                                 int smem_gamma, int split, int threads,
                                 int inverse, int bf16, void* stream) {
  const long long smem = smem_bytes(c, tile_rows, smem_gamma);
  const int p3_tiles = cdiv(c, kP3) * cdiv(c + 1, kP3);
  const int warps = threads / 32;
  if (n < 1 || c < 1 || (rm != 2 && rm != 4) || tile_rows < 8 * rm ||
      tile_rows % (8 * rm) || blocks < 1 ||
      blocks > (n + tile_rows - 1) / tile_rows ||
      (smem_gamma != 0 && smem_gamma != 1) || smem > kMaxSmem ||
      (!smem_gamma && gamma_pad == nullptr) ||
      (threads != kThreads && (threads != kWide || !split)) || split < 0 ||
      split > warps ||
      (split && (rm != 2 || !smem_gamma || p3_tiles * split > warps ||
                 p3_tiles * 1024 > 4 * tile_rows * row_stride(c))))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!smem_gamma) {
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
      bf16 ? launch_type<__nv_bfloat16>(a, rm, smem_gamma, threads)
           : launch_type<float>(a, rm, smem_gamma, threads);
  if (rc != 0) return rc;
  gdn_backward_sum_kernel<<<cdiv(c * (c + 1), 32), kThreads, 0, st>>>(
      partial, blocks, c, inverse ? 0.5f : -0.5f, dgamma, dbeta);
  return static_cast<int>(cudaGetLastError());
}
