// (I)GDN over the rows of a channel-minor (N, C) float32 or bfloat16 matrix.
//
// Replaces mmnc_tpu/ops/gdn_pallas.py:_gdn_forward (kernel body
// _gdn_kernel): out[r, o] = x[r, o] * rsqrt(beta[o] + sum_j gamma[o, j] *
// x[r, j]^2) for GDN, * sqrt(...) for IGDN. gamma is (C, C) in [out, in]
// layout. A product with M = N rows and N = K = C, a square before it and
// an elementwise epilogue after.
//
// Bound on the H100: each row of C floats is read once and written once
// (8*C bytes) against C*C FMAs, i.e. C/4 FLOP per byte. The CUDA cores'
// f32 rate (67 TFLOP/s) and HBM (3.35 TB/s) balance at 20 FLOP per byte,
// so C = 50 is bound by bytes and C = 100 by f32 FMAs, both close to the
// balance point: the kernel has to stream rows at HBM rate and run FMAs
// at near the CUDA cores' rate at once.
//
// Design (exact f32 on CUDA cores; no tensor cores, no atomics, no split of
// the input channels, so two launches on the same input are bitwise
// equal):
// - Register micro-tiles. Shared memory hands a warp at most 32 floats per
//   clock while the SM runs 128 FMAs, so every float a thread loads has
//   to feed 4 or more FMAs. A warp is 8 row groups x 4 channel groups; a
//   thread accumulates kRM rows x kCN = 7 output channels (rows rg + 8i,
//   channels cg + 4k of its warp's 8*kRM x 28 tile). Per 4 input channels
//   it reads kCN float4s of gamma rows and kRM float4s of squared rows and
//   does 28*kRM FMAs: at kRM = 8, 15 loads for 224 FMAs, 3.7 FMAs per
//   float. The 8 row groups read 8 consecutive rows and the 4 channel
//   groups 4 consecutive gamma rows; both are stored with a row stride of
//   an odd number of float4s, so a load's distinct addresses fall in
//   distinct banks and the rest are broadcasts. 28-channel warp columns
//   pad C = 100 to 112 and 50 to 56. kRM = 2 serves small row counts,
//   where a thread's serial work, not the FMA rate, sets the time. The
//   padded channel count CP (C rounded up to 4) is a template parameter
//   for the counts the path uses (4, 52, 100, 128) so the inner loop
//   unrolls; other C take a generic instantiation, which walks the
//   columns of its staging loops in chunks of 128, so any C whose plan's
//   shared memory fits runs (C > 128 takes 56- or 28-channel slices of
//   16-64 rows: ops/gdn.py:gdn_plan).
// - Bulk-copy staging. Blocks are persistent; each owns one slice of the
//   output channels (blockIdx.y). One thread copies that slice of gamma
//   (contiguous rows) with one bulk (TMA) copy into a landing area, which
//   the block re-lays at the padded stride once (no division per element);
//   the landing area is the x^2 tile's, free until the first tile. Row
//   tiles are contiguous runs of tile_rows * C floats; the same thread
//   moves each with a bulk copy onto an mbarrier into a ring of 2-4
//   stages, so the next tiles' copies are in flight while the current one
//   is squared (into the padded x^2 tile) and multiplied. Bulk copies move
//   multiples of 16 bytes: a ragged end's last 1-3 floats are copied by the
//   same thread with plain loads before it arrives on the barrier.
// - Stores. A thread's outputs (8 rows x 4 consecutive channels per store
//   instruction) would be scattered 16-byte pieces; instead each thread
//   writes them in place of its inputs in the tile's stage, and the block
//   then stores its slice's columns of the tile row by row, 32 consecutive
//   floats per warp instruction.
// - Launch plan (ops/gdn.py:gdn_plan). Rows: kRM = 8, all channels per
//   block, as many blocks as are resident, each walking tiles. Split: for
//   row counts whose tiles would fill fewer than half the SMs, kRM = 2 and
//   one block per (tile, 56-channel slice), so each block stages only its
//   gamma rows and a thread's serial work is short.
//
// - bfloat16 activations (the bf16 model, ops/layers.py): x and out are
//   bf16, gamma and beta stay float32 as the layer holds them. Only the
//   staged row tiles and the stores change type; the squaring relayout
//   widens each value to float32, so the squares, the product, beta and
//   the (r)sqrt are float32 and the output is rounded once, at the store
//   into the stage, as the Pallas kernel rounds its f32 accumulator once.
//   A tile starts at a multiple of tile_rows (>= 16) rows, so its first
//   byte is 32-byte aligned in either type; bulk copies move multiples of
//   16 bytes (8 bf16 values) and plain loads the ragged end's last 1-7.
//
// What is left (PERF.md): at the large shapes the product runs near
// the FMA rate, but squaring, normalising and storing a tile take about as
// long again and do not overlap the product within a block, and the
// shared memory they need keeps one block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCN = 7;          // output channels per thread
constexpr int kWarpCols = 28;   // 4 channel groups x kCN
constexpr int kMaxThreads = 256;
constexpr int kMaxStages = 4;
// Dynamic shared memory a block may use: the H100's 227 KB less 1 KB.
constexpr int kMaxSmem = 227 * 1024 - 1024;

__host__ __device__ constexpr int padded(int c) { return (c + 3) / 4 * 4; }

// Activation values in float32 arithmetic, and back (round to nearest even).
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

// Row stride of the gamma and x^2 tiles: CP floats, plus 4 where CP / 4 is
// even, so that consecutive rows start in distinct 16-byte bank groups.
__host__ __device__ constexpr int row_stride(int cp) {
  return (cp / 4) % 2 ? cp : cp + 4;
}

// Floats of the x^2 tile, which is also gamma's landing area.
__host__ __device__ constexpr int x2_floats(int c, int tile_rows,
                                            int slice) {
  return tile_rows * row_stride(padded(c)) > slice * c
             ? tile_rows * row_stride(padded(c)) : slice * c;
}

// Bytes of shared memory of one block: the ring of raw row tiles of
// `elt`-byte values (first, so bulk copies land 16-byte aligned), then
// float32: gamma's slice at the padded stride, the x^2 tile and beta's
// slice. ops/gdn.py:gdn_smem_bytes mirrors it.
__host__ __device__ constexpr int smem_bytes(int c, int tile_rows, int slice,
                                             int stages, int elt) {
  return stages * tile_rows * c * elt +
         4 * (slice * row_stride(padded(c)) + x2_floats(c, tile_rows, slice) +
              slice);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}

// The calling thread arrives (release: its earlier shared-memory stores are
// seen by the waiters) and announces `bytes` of bulk copies.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// One bulk (TMA) copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from global to this block's shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Rows [0, rows) of `src` (stride c, float32 or bf16) into the float32
// `dst` at stride ls and CP columns, squared (in float32) if kSquare, zero
// past column c and, up to `rows_out`, past row `rows`. Each warp takes
// rows warp, warp + nwarps, ...; 4 rows x kJ column chunks of 32 per pass,
// all loads before the stores, so a warp has up to 4 kJ loads in flight
// instead of one.
// Columns from j0 on, 32 * kJ of them per call.
template <int kJ, bool kSquare, typename S>
__device__ __forceinline__ void relayout(float* dst, int ls,
                                         const S* src, int c, int cp,
                                         int rows, int rows_out, int warp,
                                         int nwarps, int lane, int j0) {
  for (int r0 = warp; r0 < rows_out; r0 += 4 * nwarps) {
    float v[4][kJ];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * nwarps;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = j0 + lane + 32 * jj;
        v[u][jj] = (r < rows && j < c) ? widen(src[r * c + j]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * nwarps;
      if (r >= rows_out) break;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = j0 + lane + 32 * jj;
        if (j < cp) dst[r * ls + j] = kSquare ? v[u][jj] * v[u][jj] : v[u][jj];
      }
    }
  }
}

// Columns [o0, o0 + cols) of rows [0, rows) of the shared tile `src`
// (stride c) to the same places of `dst` in global memory: each warp
// stores runs of a row's consecutive floats, 4 rows x kJ chunks of 32 per
// pass with the loads first; columns from j0 on, 32 * kJ of them per call.
template <int kJ, typename E>
__device__ __forceinline__ void copy_out(E* dst, const E* src, int c,
                                         int o0, int cols, int rows,
                                         int warp, int nwarps, int lane,
                                         int j0) {
  for (int r0 = warp; r0 < rows; r0 += 4 * nwarps) {
    E v[4][kJ];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * nwarps;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = j0 + lane + 32 * jj;
        if (r < rows && j < cols) v[u][jj] = src[r * c + o0 + j];
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * nwarps;
      if (r >= rows) break;
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        const int j = j0 + lane + 32 * jj;
        if (j < cols) dst[static_cast<long long>(r) * c + o0 + j] = v[u][jj];
      }
    }
  }
}

// Copy `count` values from global `src` to shared `dst` onto `bar`: a
// bulk copy of the first whole 16 bytes' worth (count & ~3 floats, count
// & ~7 bf16 values), the rest with plain loads before the arrival. Called
// by one thread.
template <typename E>
__device__ __forceinline__ void stage(E* dst, const E* src, int count,
                                      unsigned long long* bar) {
  constexpr int kVec = 16 / sizeof(E);
  const int bulk = count & ~(kVec - 1);
  for (int e = bulk; e < count; ++e) dst[e] = src[e];
  mbar_expect(bar, bulk * sizeof(E));
  if (bulk) bulk_copy(dst, src, bulk * sizeof(E), bar);
}

// Grid (blocks per slice, slices); blockDim = tile_rows / (8 * kRM) *
// slice / 28 warps. E: the activations' type (float or __nv_bfloat16).
// kCP: C padded to 4 (0: generic, from c). x and gamma 16-byte aligned.
template <typename E, int kCP, int kRM>
__global__ void __launch_bounds__(kMaxThreads, 1)
gdn_kernel(const E* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, E* __restrict__ out, int n,
           int c, int tile_rows, int slice, int stages, int inverse) {
  constexpr int kWarpRows = 8 * kRM;
  constexpr int kJ = kCP ? (kCP + 31) / 32 : 4;  // 32-column chunks
  const int cp = kCP ? kCP : padded(c);
  const int ls = row_stride(cp);
  // passes of 32 * kJ columns over CP (and over a slice's columns): one
  // where CP is fixed, as many as C needs in the generic instantiation
  auto passes = [](int cols) {
    return kCP ? 1 : (cols + 32 * kJ - 1) / (32 * kJ);
  };
  __shared__ unsigned long long bar_s[kMaxStages + 1];  // ring, gamma
  extern __shared__ float4 smem4[];
  E* raw_s = reinterpret_cast<E*>(smem4);  // stages x tile_rows*c
  // slice x ls; 32-byte aligned (tile_rows is a multiple of 16)
  float* g_s = reinterpret_cast<float*>(raw_s + stages * tile_rows * c);
  float* x2_s = g_s + slice * ls;                  // tile_rows x ls
  float* b_s = x2_s + x2_floats(c, tile_rows, slice);  // slice
  unsigned long long* g_bar = &bar_s[kMaxStages];

  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int o0 = blockIdx.y * slice;  // this block's first output channel
  const int g_rows = c - o0 < slice ? c - o0 : slice;
  const int tiles = (n + tile_rows - 1) / tile_rows;
  // this block's tiles: blockIdx.x + k * gridDim.x, k < mine
  const int mine = static_cast<int>(blockIdx.x) < tiles
                       ? (tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const bool issuer = tid == 0;

  auto tile_row0 = [&](int k) {
    return static_cast<long long>(blockIdx.x + k * gridDim.x) * tile_rows;
  };
  auto tile_count = [&](long long row0) {
    return static_cast<int>(n - row0 < tile_rows ? n - row0 : tile_rows);
  };
  // Copy this block's k-th tile into stage k % stages.
  auto load = [&](int k) {
    const long long row0 = tile_row0(k);
    stage(raw_s + (k % stages) * tile_rows * c, x + row0 * c,
          tile_count(row0) * c, &bar_s[k % stages]);
  };

  if (issuer) {
    for (int s = 0; s <= kMaxStages; ++s) mbar_init(&bar_s[s]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // gamma rows o0 .. o0 + g_rows into the landing area (the x^2 tile)
    stage(x2_s, gamma + static_cast<long long>(o0) * c, g_rows * c, g_bar);
    for (int k = 0; k < stages && k < mine; ++k) load(k);
  }
  // beta of the slice; 1 past C (the padded channels are never written,
  // but their (r)sqrt stays finite)
  for (int o = tid; o < slice; o += nthreads)
    b_s[o] = o0 + o < c ? beta[o0 + o] : 1.f;
  __syncthreads();  // barriers initialised
  mbar_wait(g_bar, 0);
  // gamma at the padded stride, zero past C and past the slice's rows
  for (int p = 0; p < passes(cp); ++p)
    relayout<kJ, false>(g_s, ls, x2_s, c, cp, g_rows, slice, warp, nwarps,
                        lane, 32 * kJ * p);
  __syncthreads();  // gamma staged; the landing area is free

  // thread (warp row wr, warp column wc; row group rg, channel group cg)
  const int wcols = slice / kWarpCols;
  const int wr = warp / wcols, wc = warp - wr * wcols;
  const int rg = lane & 7, cg = lane >> 3;
  const int r_base = wr * kWarpRows + rg;  // rows r_base + 8i
  const int o_base = wc * kWarpCols + cg;  // slice channels o_base + 4k
  const int q = ls / 4;                    // row stride in float4s
  const float4* x4 = reinterpret_cast<const float4*>(x2_s + r_base * ls);
  const float4* g4 = reinterpret_cast<const float4*>(g_s + o_base * ls);

  for (int k = 0; k < mine; ++k) {
    const int s = k % stages;
    E* raw = raw_s + s * tile_rows * c;
    const long long row0 = tile_row0(k);
    const int rows = tile_count(row0);
    mbar_wait(&bar_s[s], (k / stages) & 1);

    // squares into the padded tile, zero past C. Rows past the last are
    // left as they are: each row's sums use only its own squares, and
    // their outputs are not stored.
    for (int p = 0; p < passes(cp); ++p)
      relayout<kJ, true>(x2_s, ls, raw, c, cp, rows, rows, warp, nwarps,
                         lane, 32 * kJ * p);
    __syncthreads();
    // a warp whose rows all lie past the last has nothing to compute
    if (wr * kWarpRows < rows) {
      float acc[kRM][kCN];
#pragma unroll
      for (int kk = 0; kk < kCN; ++kk) {
        const float bv = b_s[o_base + 4 * kk];
#pragma unroll
        for (int i = 0; i < kRM; ++i) acc[i][kk] = bv;
      }
      auto step = [&](int j4) {
        float4 gv[kCN];
#pragma unroll
        for (int kk = 0; kk < kCN; ++kk) gv[kk] = g4[4 * kk * q + j4];
#pragma unroll
        for (int i = 0; i < kRM; ++i) {
          const float4 xv = x4[8 * i * q + j4];
#pragma unroll
          for (int kk = 0; kk < kCN; ++kk) {
            acc[i][kk] = fmaf(gv[kk].x, xv.x, acc[i][kk]);
            acc[i][kk] = fmaf(gv[kk].y, xv.y, acc[i][kk]);
            acc[i][kk] = fmaf(gv[kk].z, xv.z, acc[i][kk]);
            acc[i][kk] = fmaf(gv[kk].w, xv.w, acc[i][kk]);
          }
        }
      };
      if constexpr (kCP != 0) {
#pragma unroll
        for (int j4 = 0; j4 < kCP / 4; ++j4) step(j4);
      } else {
#pragma unroll 2
        for (int j4 = 0; j4 < cp / 4; ++j4) step(j4);
      }

#pragma unroll
      for (int i = 0; i < kRM; ++i) {
        const int r = r_base + 8 * i;
        if (r >= rows) continue;
#pragma unroll
        for (int kk = 0; kk < kCN; ++kk) {
          const int o = o0 + o_base + 4 * kk;
          if (o >= c) continue;
          // in place: this thread alone reads and writes element (r, o);
          // the one rounding to E
          const float xv = widen(raw[r * c + o]);
          const float t = rsqrtf(acc[i][kk]);
          raw[r * c + o] = narrow<E>(xv * (inverse ? acc[i][kk] * t : t));
        }
      }
    }
    __syncthreads();  // the stage holds the slice's outputs
    // coalesced stores of this slice's columns of the tile
    for (int p = 0; p < passes(g_rows); ++p)
      copy_out<kJ>(out + row0 * c, raw, c, o0, g_rows, rows, warp, nwarps,
                   lane, 32 * kJ * p);
    __syncthreads();  // stage s and the x^2 tile are no longer read
    if (issuer && k + stages < mine) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load(k + stages);
    }
  }
}

// cudaFuncSetAttribute once per instantiation (and process: the port runs
// on one card), not on every launch.
template <typename E, int kCP, int kRM>
cudaError_t ready() {
  static const cudaError_t err = cudaFuncSetAttribute(
      gdn_kernel<E, kCP, kRM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  return err;
}

template <typename E, int kCP, int kRM>
int launch(const void* x, const float* gamma, const float* beta, void* out,
           int n, int c, int tile_rows, int slice, int blocks, int stages,
           int inverse, cudaStream_t st, size_t smem) {
  const cudaError_t err = ready<E, kCP, kRM>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks, (c + slice - 1) / slice);
  const int threads = tile_rows / (8 * kRM) * (slice / kWarpCols) * 32;
  gdn_kernel<E, kCP, kRM><<<grid, threads, smem, st>>>(
      static_cast<const E*>(x), gamma, beta, static_cast<E*>(out), n, c,
      tile_rows, slice, stages, inverse);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int kRM>
int launch_rm(const void* x, const float* gamma, const float* beta,
              void* out, int n, int c, int tile_rows, int slice, int blocks,
              int stages, int inverse, cudaStream_t st, size_t smem) {
  switch (padded(c)) {
    case 4:
      return launch<E, 4, kRM>(x, gamma, beta, out, n, c, tile_rows, slice,
                               blocks, stages, inverse, st, smem);
    case 52:
      return launch<E, 52, kRM>(x, gamma, beta, out, n, c, tile_rows, slice,
                                blocks, stages, inverse, st, smem);
    case 100:
      return launch<E, 100, kRM>(x, gamma, beta, out, n, c, tile_rows, slice,
                                 blocks, stages, inverse, st, smem);
    case 128:
      return launch<E, 128, kRM>(x, gamma, beta, out, n, c, tile_rows, slice,
                                 blocks, stages, inverse, st, smem);
    default:
      return launch<E, 0, kRM>(x, gamma, beta, out, n, c, tile_rows, slice,
                               blocks, stages, inverse, st, smem);
  }
}

template <typename E>
int launch_type(const void* x, const float* gamma, const float* beta,
                void* out, int n, int c, int rm, int tile_rows, int slice,
                int blocks, int stages, int inverse, cudaStream_t st,
                size_t smem) {
  if (rm == 8)
    return launch_rm<E, 8>(x, gamma, beta, out, n, c, tile_rows, slice,
                           blocks, stages, inverse, st, smem);
  return launch_rm<E, 2>(x, gamma, beta, out, n, c, tile_rows, slice, blocks,
                         stages, inverse, st, smem);
}

}  // namespace

// x, out: (n, c) row-major, float32, or bfloat16 where bf16 != 0; gamma
// (c, c) and beta (c,) float32; x and gamma 16-byte aligned; any c >= 1
// whose plan's shared memory fits. The plan (ops/gdn.py:gdn_plan): rm
// (rows per thread) 2 or 8, tile_rows a multiple of 8 * rm, slice (output
// channels per block) a multiple of 28, at most 256 threads (tile_rows /
// (8 * rm) * slice / 28 warps), blocks per slice >= 1, stages 2-4.
// Launches on `stream`; returns the launch's CUDA error (0 on success), or
// cudaErrorInvalidValue for a plan it has no kernel or shared memory for.
extern "C" int mmnc_gdn_forward(const void* x, const float* gamma,
                                const float* beta, void* out, int n, int c,
                                int rm, int tile_rows, int slice, int blocks,
                                int stages, int inverse, int bf16,
                                void* stream) {
  if (n <= 0) return 0;
  const int warp_rows = 8 * rm;
  const int threads =
      warp_rows > 0 ? tile_rows / warp_rows * (slice / kWarpCols) * 32 : 0;
  const size_t smem = static_cast<size_t>(smem_bytes(
      c, tile_rows, slice, stages,
      bf16 ? static_cast<int>(sizeof(__nv_bfloat16)) : 4));
  if (c < 1 || (rm != 2 && rm != 8) || tile_rows < warp_rows ||
      tile_rows % warp_rows || slice < kWarpCols || slice % kWarpCols ||
      threads > kMaxThreads || blocks < 1 || stages < 2 ||
      stages > kMaxStages || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(x, gamma, beta, out, n, c, rm,
                                      tile_rows, slice, blocks, stages,
                                      inverse, st, smem);
  return launch_type<float>(x, gamma, beta, out, n, c, rm, tile_rows, slice,
                            blocks, stages, inverse, st, smem);
}
