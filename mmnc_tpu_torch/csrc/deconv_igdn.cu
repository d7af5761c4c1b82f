// Transposed conv k5/s2 (padding 2, output_padding 1) + optional (I)GDN,
// NHWC float32 or bfloat16 activations, writing the interleaved (B, 2H, 2W,
// Cout) output directly.
//
// Replaces mmnc_tpu/ops/deconv_igdn_pallas.py:deconv_igdn_pallas (kernel
// body _kernel). As there, the transposed conv splits into 4 output-parity
// planes: along each axis, parity 0 takes taps {0,2,4} at input offsets
// {-1,0,+1} and parity 1 takes taps {1,3} at offsets {0,+1} (_TAPS), i.e.
// tap t of parity d sits at input offset t + d - 1 and kernel index 2t + d.
// The weight is in the JAX (5, 5, Cin, Cout) cross-correlation layout, the
// spatial flip of torch ConvTranspose2d's (Cin, Cout, 5, 5).
//
// Bound on the H100: f32 FMAs for the 100- and 50-channel stages
// (25*Cin*Cout/4 FMAs per output pixel against 4*Cout bytes written) and
// bytes for the 3-channel ones. The TPU kernel held one whole image per
// program in VMEM (grid (B,), the 5x5xCinxCout weight resident) and let the
// sequential grid walk the batch; it could not fit 64x64 and 128x128
// inputs. The card runs blocks in parallel on 132 SMs, so the work has to
// be cut finer, two ways:
//
// Tiled (deconv_igdn_kernel; wide stages and 3-channel stages): a block
// owns a tile of TA x TB input positions, i.e. 2TA x 2TB output pixels
// times all Cout channels (the IGDN epilogue mixes every channel of a
// pixel). It stages its input tile with a 1-pixel halo in shared memory,
// streams the weight from L2 (1 MB at 100x100: read once per tap and input
// channel and reused for kCols output pixels from a register), accumulates
// the pre-activation in registers, parks it in shared memory, applies the
// (I)GDN epilogue with gamma in shared memory and writes each output pixel
// once, already interleaved: no depth-to-space pass. Taps that fall wholly
// on the zero padding are skipped. Where Cout x Cout of gamma does not fit
// beside the tile (Cout above about 230), the kGammaL2 instantiation
// leaves gamma in global memory and its epilogue reads it through the
// read-only cache (__ldg; 360 KB at Cout = 300 stays in L2): correct at
// any width, not tuned.
//
// Split (deconv_igdn_split_kernel; the latent stages, 1x1 to 4x4 inputs):
// there the tiles give 8-32 blocks for 132 SMs, and each thread walks every
// tap x all Cin with one dependent L2 load per FMA, so the stage is latency,
// not work. Instead a thread-block cluster of S blocks (2, 4 or 8) owns one
// tile, all 4 parities and all Cout, and block rank r takes a contiguous
// slice of Cin (the first Cin % S ranks one channel longer) over every tap
// the tile needs:
// - one thread streams the block's weight slice into shared memory in
//   chunks of Cin with bulk (TMA) copies, one per tap, double buffered on
//   two mbarriers, while the others compute on the previous chunk; gamma and
//   beta come on a third barrier that only the epilogue waits for. No thread
//   waits on a dependent L2 load;
// - a thread owns (parity, up to 8 tile positions, 4 output channels) and
//   keeps those sums in registers: per input channel and tap it reads one
//   float4 of weights and one broadcast input value per position;
// - partial sums go to each block's shared memory. After cluster.sync() rank
//   r reads every rank's partials of the pixels p = r (mod S) through
//   distributed shared memory, adds them in rank order (so two launches are
//   bitwise equal) and runs the bias + (I)GDN epilogue on whole pixels. A
//   second cluster.sync() keeps each block's partials alive until the
//   remote reads are done.
// Plain FMAs, exact f32, no tensor cores.
//
// bfloat16 activations (the bf16 model): x and out are bf16; the weights,
// bias, gamma and beta stay float32 (the layer hands over values rounded to
// bf16), so the weight staging and gamma's do not change. x widens to
// float32 as it is staged (plain loads: a bf16 channel at an odd offset is
// not 4-byte aligned for cp.async, and the split stages' inputs are 1x1 to
// 4x4), the sums are float32, and y is rounded to bf16 before the epilogue
// as the unfused chain rounds it: the sum of products (the bf16 conv's
// output), then that + the bias (the bf16 bias add); the output is rounded
// once more at the store. (Rounding sum + bias once instead differs from
// the chain's two roundings in a large share of y values, and the IGDN,
// which squares y, amplifies that difference.)

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
// Dynamic shared memory allowed per block: the H100's 227 KB less room for
// the split kernel's static tap tables.
constexpr int kMaxSmem = 227 * 1024 - 1024;
constexpr int kMaxChunk = 16;  // Cin channels per staged weight chunk

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
// v as the activation type E holds it.
template <typename E>
__device__ __forceinline__ float held(float v) {
  return widen(narrow<E>(v));
}
// The sum of products starts at the bias in float32 and at 0 in bf16, and
// pre_activation makes y of it: itself in float32, in bf16 the sum
// rounded, plus the bias, rounded.
template <typename E>
__device__ __forceinline__ float acc_start(float bias) {
  return std::is_same<E, float>::value ? bias : 0.f;
}
template <typename E>
__device__ __forceinline__ float pre_activation(float acc, float bias) {
  return std::is_same<E, float>::value ? acc
                                       : held<E>(held<E>(acc) + bias);
}

// E: the activations' type. kCols: input columns (same parity) per thread,
// 4 or, for tiles narrower than 4, 1. kGammaL2: gamma stays in global
// memory (see above).
template <typename E, int kCols, bool kGammaL2>
__global__ void __launch_bounds__(kThreads)
deconv_igdn_kernel(const E* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, E* __restrict__ out,
                   int h, int wd, int cin, int cout, int ta, int tb,
                   int mode) {
  extern __shared__ float smem[];
  const int hx = ta + 2, wx = tb + 2;
  const int pix = 4 * ta * tb;            // output pixels of the tile
  float* x_s = smem;                      // hx*wx*cin, input tile + halo
  float* y_s = x_s + hx * wx * cin;       // pix*cout, output-pixel order
  float* g_t = y_s + pix * cout;          // cout*cout, g_t[j*cout+o]
  float* b_s = g_t + (mode && !kGammaL2 ? cout * cout : 0);  // cout

  const int n = blockIdx.z;
  const int a0 = blockIdx.y * ta, b0 = blockIdx.x * tb;

  for (int i = threadIdx.x; i < hx * wx * cin; i += blockDim.x) {
    const int ci = i % cin;
    const int p = i / cin;
    const int ia = a0 - 1 + p / wx, ib = b0 - 1 + p % wx;
    x_s[i] = (ia >= 0 && ia < h && ib >= 0 && ib < wd)
                 ? widen(x[((static_cast<long long>(n) * h + ia) * wd + ib) *
                               cin + ci])
                 : 0.f;
  }
  if (mode) {
    if (!kGammaL2) {
      for (int i = threadIdx.x; i < cout * cout; i += blockDim.x) {
        const int o = i / cout;
        const int j = i - o * cout;
        g_t[j * cout + o] = gamma[i];
      }
    }
    for (int i = threadIdx.x; i < cout; i += blockDim.x) b_s[i] = beta[i];
  }
  __syncthreads();

  // item = (parity q, tile row a, column group g, output channel co);
  // co fastest so a warp's threads share one input address (broadcast)
  // and read consecutive weights (coalesced).
  const int groups = tb / kCols;
  const int items = 4 * ta * groups * cout;
  for (int item = threadIdx.x; item < items; item += blockDim.x) {
    const int co = item % cout;
    int rest = item / cout;
    const int g = rest % groups;
    rest /= groups;
    const int a = rest % ta;
    const int q = rest / ta;
    const int dh = q >> 1, dw = q & 1;
    float acc[kCols];
    const float bv = bias[co];
#pragma unroll
    for (int k = 0; k < kCols; ++k) acc[k] = acc_start<E>(bv);
    const int col0 = b0 + g * kCols + dw - 1;  // input column of k=0, s=0
    for (int t = 0; t < 3 - dh; ++t) {
      const int ia = a0 + a + t + dh - 1;
      if (ia < 0 || ia >= h) continue;  // tap row on the zero padding
      for (int s = 0; s < 3 - dw; ++s) {
        if (col0 + s + kCols - 1 < 0 || col0 + s >= wd) continue;
        // tap (t, s): kernel index (2t+dh, 2s+dw), halo-tile offset (t+dh, s+dw)
        const float* wp =
            w + static_cast<long long>(((2 * t + dh) * 5 + 2 * s + dw) * cin) *
                    cout + co;
        const float* xp = x_s + ((a + t + dh) * wx + g * kCols + s + dw) * cin;
        for (int ci = 0; ci < cin; ++ci) {
          const float wv = __ldg(wp + static_cast<long long>(ci) * cout);
#pragma unroll
          for (int k = 0; k < kCols; ++k)
            acc[k] = fmaf(xp[k * cin + ci], wv, acc[k]);
        }
      }
    }
    const int orow = 2 * a + dh;
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int ocol = 2 * (g * kCols + k) + dw;
      y_s[(orow * 2 * tb + ocol) * cout + co] = pre_activation<E>(acc[k], bv);
    }
  }
  __syncthreads();

  // epilogue: item = (output pixel p in row-major tile order, channel o);
  // consecutive items are consecutive addresses of the interleaved output.
  const int oh = 2 * h, ow = 2 * wd;
  for (int item = threadIdx.x; item < pix * cout; item += blockDim.x) {
    const int o = item % cout;
    const int p = item / cout;
    const int gy = 2 * a0 + p / (2 * tb), gx = 2 * b0 + p % (2 * tb);
    if (gy >= oh || gx >= ow) continue;
    float v = y_s[item];
    if (mode) {
      const float* yp = y_s + p * cout;
      float norm = b_s[o];
      const float* gr = gamma + static_cast<long long>(o) * cout;
      for (int j = 0; j < cout; ++j) {
        const float yj = yp[j];
        const float gv = kGammaL2 ? __ldg(gr + j) : g_t[j * cout + o];
        norm = fmaf(gv, yj * yj, norm);
      }
      v = (mode == 1) ? v * sqrtf(norm) : v * rsqrtf(norm);
    }
    out[((static_cast<long long>(n) * oh + gy) * ow + gx) * cout + o] =
        narrow<E>(v);
  }
}

// ---- split kernel -----------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar)));
}

// The calling thread arrives and announces `bytes` of bulk copies.
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
__device__ __forceinline__ void bulk_copy(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Input offset of kernel index k along one axis: t + d - 1 with t = k / 2,
// d = k % 2.
__host__ __device__ __forceinline__ int tap_offset(int k) {
  return (k >> 1) + (k & 1) - 1;
}

// Whether kernel index k reads any in-image input for the tile positions
// [p0, p0 + t) of an axis of length n (positions past n are not output).
__host__ __device__ __forceinline__ bool tap_hits(int k, int p0, int t,
                                                  int n) {
  const int last = (p0 + t < n ? p0 + t : n) - 1;
  const int off = tap_offset(k);
  return p0 + off <= n - 1 && last + off >= 0;
}

// Cin slice of cluster rank r: the first cin % s ranks take one channel
// more (ops/deconv_igdn.py:cin_slices).
__host__ __device__ __forceinline__ void cin_slice(int cin, int s, int r,
                                                   int* c0, int* cs) {
  const int base = cin / s, rem = cin % s;
  *c0 = r * base + (r < rem ? r : rem);
  *cs = base + (r < rem ? 1 : 0);
}

// Positions per thread of a T x T tile's parity plane: all of them up to
// 8, else 8 (so a 4x4 tile has two position groups).
__host__ __device__ constexpr int split_rp(int t) {
  return t * t < 8 ? t * t : 8;
}

// Threads of the split kernel: one per (parity, position group, 4 output
// channels), rounded up to whole warps.
__host__ __device__ __forceinline__ int split_threads(int t, int cout) {
  return (4 * (t * t / split_rp(t)) * (cout / 4) + 31) / 32 * 32;
}

// Shared-memory floats of the split kernel apart from the weight stages:
// partial sums, reduced rows and their squares, gamma, beta and the input
// tile (+ halo).
__host__ __device__ __forceinline__ int split_fixed_floats(
    int t, int cs_max, int cout, int s, int mode) {
  const int pix = 4 * t * t;
  return pix * cout + 2 * ((pix + s - 1) / s) * cout +
         (mode ? cout * cout + cout : 0) + (t + 2) * (t + 2) * cs_max;
}

// Grid (S, tiles, B), cluster (S, 1, 1), split_threads(T, cout) threads;
// cout a multiple of 4; w, gamma and beta 16-byte aligned (bulk copies).
// E: the activations' type. chunk: Cin channels per staged weight chunk.
template <typename E, int T>
__global__ void __launch_bounds__(256)
deconv_igdn_split_kernel(const E* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta,
                         E* __restrict__ out, int h, int wd, int cin,
                         int cout, int mode, int chunk) {
  constexpr int kW = T + 2, kHW = kW * kW;  // input tile + halo
  constexpr int kPix = 4 * T * T;           // output pixels of the tile
  constexpr int kRP = split_rp(T);          // positions per thread
  constexpr int kG = T * T / kRP;           // position groups per parity
  __shared__ int tap_s[25];                 // slot -> kernel index kh*5+kw
  __shared__ int slot_s[25];                // kernel index -> slot or -1
  __shared__ int nv_s;
  __shared__ unsigned long long bar_s[3];   // weight stages 0, 1; gamma

  cg::cluster_group cluster = cg::this_cluster();
  const int splits = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  int c0, cs;
  cin_slice(cin, splits, rank, &c0, &cs);
  const int npr = (kPix + splits - 1) / splits;  // pixels per rank

  // part_s first: the same offset in every rank, read remotely.
  extern __shared__ float4 smem4[];
  float* part_s = reinterpret_cast<float*>(smem4);  // kPix x cout partials
  float* red_s = part_s + kPix * cout;              // npr x cout reduced
  float* y2_s = red_s + npr * cout;                 // their squares
  float* w_s = y2_s + npr * cout;  // 2 stages x nv x chunk x cout

  const int tiles_w = (wd + T - 1) / T;
  const int n = blockIdx.z;
  const int a0 = blockIdx.y / tiles_w * T, b0 = blockIdx.y % tiles_w * T;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  if (tid < 32) {  // the taps this tile needs, in kernel-index order
    const bool hit = tid < 25 && tap_hits(tid / 5, a0, T, h) &&
                     tap_hits(tid % 5, b0, T, wd);
    const unsigned mask = __ballot_sync(0xffffffffu, hit);
    const int slot = __popc(mask & ((1u << tid) - 1));
    if (tid < 25) slot_s[tid] = hit ? slot : -1;
    if (hit) tap_s[slot] = tid;
    if (tid == 0) {
      nv_s = __popc(mask);
      mbar_init(&bar_s[0]);
      mbar_init(&bar_s[1]);
      mbar_init(&bar_s[2]);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  __syncthreads();
  const int nv = nv_s;
  const int stage_floats = nv * chunk * cout;
  float* g_s = w_s + 2 * stage_floats;  // gamma [o][j], then beta
  float* x_s = g_s + (mode ? cout * cout + cout : 0);  // [ci][kHW]
  const int nchunks = (cs + chunk - 1) / chunk;

  // The first thread of the last warp, which has the fewest (parity,
  // channel) items, stages chunk k of this rank's weight slice, every tap
  // the tile needs, with one bulk copy per tap: w_s[k % 2][slot][c][co] =
  // w[tap][c0 + k*chunk + c][co].
  const bool issuer = tid == nthreads - 32;
  auto stage_chunk = [&](int k) {
    const int k0 = k * chunk;
    const int kc = cs - k0 < chunk ? cs - k0 : chunk;
    const unsigned row_bytes = kc * cout * sizeof(float);
    float* dst = w_s + (k & 1) * stage_floats;
    mbar_expect(&bar_s[k & 1], nv * row_bytes);
    for (int slot = 0; slot < nv; ++slot)
      bulk_copy(dst + slot * chunk * cout,
                w + (static_cast<long long>(tap_s[slot]) * cin + c0 + k0) *
                        cout,
                row_bytes, &bar_s[k & 1]);
  };
  if (issuer) {
    if (nchunks > 0) stage_chunk(0);
    if (mode) {  // gamma and beta, needed only by the epilogue
      mbar_expect(&bar_s[2], (cout * cout + cout) * sizeof(float));
      bulk_copy(g_s, gamma, cout * cout * sizeof(float), &bar_s[2]);
      bulk_copy(g_s + cout * cout, beta, cout * sizeof(float), &bar_s[2]);
    }
  }

  // The input tile (+ halo) of this rank's channels, zero outside the
  // image; float32 by cp.async, bf16 widened by plain loads.
  for (int i = tid; i < cs * kHW; i += nthreads) {
    const int ci = i / kHW, p = i - ci * kHW;
    const int ia = a0 - 1 + p / kW, ib = b0 - 1 + p % kW;
    if (ia >= 0 && ia < h && ib >= 0 && ib < wd) {
      const E* src =
          x + ((static_cast<long long>(n) * h + ia) * wd + ib) * cin + c0 + ci;
      if constexpr (std::is_same<E, float>::value)
        cp_async4(x_s + i, src);
      else
        x_s[i] = widen(*src);
    } else {
      x_s[i] = 0.f;
    }
  }
  cp_async_wait_all();
  __syncthreads();

  // item = (parity q, position group g, channels 4cq..4cq+3), cq fastest:
  // a warp's threads read one broadcast input value and consecutive
  // float4s of weights. Each thread keeps kRP x 4 sums in registers.
  const int nq = cout / 4;
  const bool active = tid < 4 * kG * nq;
  const int cq = tid % nq;
  const int g = (tid / nq) % kG, q = tid / nq / kG;
  const int dh = q >> 1, dw = q & 1;
  // group g covers tile rows g*kRP/T.. (kRP is a multiple of T when kG > 1)
  const int g_row = g * kRP / T;
  float acc[kRP][4];
#pragma unroll
  for (int i = 0; i < kRP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k = 0; k < nchunks; ++k) {
    if (issuer && k + 1 < nchunks) {
      // the stage was last read before the previous __syncthreads
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      stage_chunk(k + 1);
    }
    mbar_wait(&bar_s[k & 1], (k >> 1) & 1);
    const int k0 = k * chunk;
    const int kc = cs - k0 < chunk ? cs - k0 : chunk;
    const float* ws = w_s + (k & 1) * stage_floats;
    if (active) {
      for (int t = 0; t < 3 - dh; ++t) {
        for (int s = 0; s < 3 - dw; ++s) {
          const int slot = slot_s[(2 * t + dh) * 5 + 2 * s + dw];
          if (slot < 0) continue;  // tap wholly on the zero padding
          const float* wp = ws + slot * chunk * cout + 4 * cq;
          // position i of group g sits at tile (g_row + i / T, i % T),
          // halo (g_row + i / T + t + dh, i % T + s + dw)
          const float* xp =
              x_s + k0 * kHW + (g_row + t + dh) * kW + s + dw;
#pragma unroll 2
          for (int c = 0; c < kc; ++c) {
            const float4 wv = *reinterpret_cast<const float4*>(wp + c * cout);
            const float* xc = xp + c * kHW;
#pragma unroll
            for (int i = 0; i < kRP; ++i) {
              const float xv = xc[(i / T) * kW + i % T];
              acc[i][0] = fmaf(xv, wv.x, acc[i][0]);
              acc[i][1] = fmaf(xv, wv.y, acc[i][1]);
              acc[i][2] = fmaf(xv, wv.z, acc[i][2]);
              acc[i][3] = fmaf(xv, wv.w, acc[i][3]);
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two chunks later
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < kRP; ++i) {
      const int orow = 2 * (g_row + i / T) + dh, ocol = 2 * (i % T) + dw;
      *reinterpret_cast<float4*>(part_s + (orow * 2 * T + ocol) * cout +
                                 4 * cq) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
  cluster.sync();  // every rank's partial sums are written

  // Rank r reduces pixels p = r + i*S, i < npr, over ranks 0..S-1 in order,
  // 4 channels per thread (all S remote float4 loads issued before the sum).
  for (int e = tid; e < npr * nq; e += nthreads) {
    const int i = e / nq, o = 4 * (e - i * nq);
    const int p = rank + i * splits;
    if (p >= kPix) continue;
    float4 part[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (r < splits)
        part[r] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(part_s, r) + p * cout + o);
    const float4 bv =
        make_float4(bias[o], bias[o + 1], bias[o + 2], bias[o + 3]);
    float4 v = make_float4(acc_start<E>(bv.x), acc_start<E>(bv.y),
                           acc_start<E>(bv.z), acc_start<E>(bv.w));
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r < splits) {
        v.x += part[r].x;
        v.y += part[r].y;
        v.z += part[r].z;
        v.w += part[r].w;
      }
    }
    v = make_float4(pre_activation<E>(v.x, bv.x), pre_activation<E>(v.y, bv.y),
                    pre_activation<E>(v.z, bv.z), pre_activation<E>(v.w, bv.w));
    *reinterpret_cast<float4*>(red_s + i * cout + o) = v;
    *reinterpret_cast<float4*>(y2_s + i * cout + o) =
        make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
  }
  cluster.sync();  // remote reads done; red_s complete within the block
  if (mode) mbar_wait(&bar_s[2], 0);  // gamma, beta

  // item = (channel o, 4 of this rank's pixels): each gamma value read
  // serves 4 pixels; j runs from o to cout-1 and then from 0, so a warp's
  // threads read distinct banks of gamma's rows.
  constexpr int kEP = 4;
  const int oh = 2 * h, ow = 2 * wd;
  const int groups = (npr + kEP - 1) / kEP;
  for (int e = tid; e < groups * cout; e += nthreads) {
    const int pg = e / cout, o = e - pg * cout;
    float norm[kEP];
    if (mode) {
      const float* gr = g_s + o * cout;
      const float* y2 = y2_s + pg * kEP * cout;
      const int rows = npr - pg * kEP;  // rows past npr repeat the last
#pragma unroll
      for (int i = 0; i < kEP; ++i) norm[i] = g_s[cout * cout + o];
#pragma unroll 2
      for (int jj = 0, j = o; jj < cout; ++jj, j = j + 1 < cout ? j + 1 : 0) {
        const float gv = gr[j];
#pragma unroll
        for (int i = 0; i < kEP; ++i)
          norm[i] = fmaf(gv, y2[(i < rows ? i : rows - 1) * cout + j], norm[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < kEP; ++i) {
      const int row = pg * kEP + i;
      const int p = rank + row * splits;
      if (row >= npr || p >= kPix) continue;
      const int gy = 2 * a0 + p / (2 * T), gx = 2 * b0 + p % (2 * T);
      if (gy >= oh || gx >= ow) continue;
      float v = red_s[row * cout + o];
      if (mode) v = (mode == 1) ? v * sqrtf(norm[i]) : v * rsqrtf(norm[i]);
      out[((static_cast<long long>(n) * oh + gy) * ow + gx) * cout + o] =
          narrow<E>(v);
    }
  }
}

// Most valid kernel indices along one axis of length n over tiles of t.
int max_axis_taps(int n, int t) {
  int best = 0;
  for (int p0 = 0; p0 < n; p0 += t) {
    int hits = 0;
    for (int k = 0; k < 5; ++k) hits += tap_hits(k, p0, t, n) ? 1 : 0;
    best = hits > best ? hits : best;
  }
  return best;
}

// cudaFuncSetAttribute once per kernel instantiation (and process: the
// port runs on one card), not on every launch.
template <typename Kernel>
cudaError_t allow_max_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kMaxSmem);
}

template <typename E, int kCols, bool kGammaL2>
cudaError_t tiled_ready() {
  static const cudaError_t err =
      allow_max_smem(deconv_igdn_kernel<E, kCols, kGammaL2>);
  return err;
}

template <typename E, int kCols, bool kGammaL2>
int launch_tiled(const void* x, const float* w, const float* bias,
                 const float* gamma, const float* beta, void* out, int b,
                 int h, int wd, int cin, int cout, int ta, int tb, int mode,
                 size_t smem, cudaStream_t st) {
  const cudaError_t ready = tiled_ready<E, kCols, kGammaL2>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const dim3 grid((wd + tb - 1) / tb, (h + ta - 1) / ta, b);
  deconv_igdn_kernel<E, kCols, kGammaL2><<<grid, kThreads, smem, st>>>(
      static_cast<const E*>(x), w, bias, gamma, beta, static_cast<E*>(out), h,
      wd, cin, cout, ta, tb, mode);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, int T>
cudaError_t split_ready() {
  static const cudaError_t err =
      allow_max_smem(deconv_igdn_split_kernel<E, T>);
  return err;
}

template <typename E, int T>
int launch_split(const void* x, const float* w, const float* bias,
                 const float* gamma, const float* beta, void* out, int b,
                 int h, int wd, int cin, int cout, int splits, int mode,
                 cudaStream_t st) {
  const cudaError_t ready = split_ready<E, T>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  int c0, cs_max;
  cin_slice(cin, splits, 0, &c0, &cs_max);
  const int nv = max_axis_taps(h, T) * max_axis_taps(wd, T);
  const int fixed = split_fixed_floats(T, cs_max, cout, splits, mode);
  int chunk = kMaxChunk < cs_max ? kMaxChunk : cs_max;  // cs_max >= 1
  while (chunk > 1 && static_cast<size_t>(fixed + 2 * nv * chunk * cout) *
                              sizeof(float) > kMaxSmem)
    --chunk;
  const size_t smem =
      static_cast<size_t>(fixed + 2 * nv * chunk * cout) * sizeof(float);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, ((h + T - 1) / T) * ((wd + T - 1) / T), b);
  cfg.blockDim = dim3(split_threads(T, cout));
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, deconv_igdn_split_kernel<E, T>, static_cast<const E*>(x), w, bias,
      gamma, beta, static_cast<E*>(out), h, wd, cin, cout, mode, chunk);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <typename E>
int launch_type(const void* x, const float* w, const float* bias,
                const float* gamma, const float* beta, void* out, int b,
                int h, int wd, int cin, int cout, int ta, int tb, int splits,
                int mode, int gamma_l2, cudaStream_t st) {
  if (splits != 1) {
    const bool ok = (splits == 2 || splits == 4 || splits == 8) && ta == tb &&
                    cout > 0 && cout % 4 == 0 && cout <= 128;
    if (ok && ta == 1)
      return launch_split<E, 1>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                                cout, splits, mode, st);
    if (ok && ta == 2)
      return launch_split<E, 2>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                                cout, splits, mode, st);
    if (ok && ta == 4)
      return launch_split<E, 4>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                                cout, splits, mode, st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // ops/deconv_igdn.py:tiled_smem_bytes mirrors this
  const size_t floats =
      static_cast<size_t>((ta + 2) * (tb + 2) * cin) +
      static_cast<size_t>(4 * ta * tb * cout) +
      (mode ? static_cast<size_t>(cout) : 0) +
      (mode && !gamma_l2 ? static_cast<size_t>(cout) * cout : 0);
  const size_t smem = floats * sizeof(float);
  if (ta < 1 || tb < 1 || smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tb % 4 == 0)
    return gamma_l2 ? launch_tiled<E, 4, true>(x, w, bias, gamma, beta, out,
                                              b, h, wd, cin, cout, ta, tb,
                                              mode, smem, st)
                    : launch_tiled<E, 4, false>(x, w, bias, gamma, beta, out,
                                               b, h, wd, cin, cout, ta, tb,
                                               mode, smem, st);
  return gamma_l2 ? launch_tiled<E, 1, true>(x, w, bias, gamma, beta, out, b,
                                            h, wd, cin, cout, ta, tb, mode,
                                            smem, st)
                  : launch_tiled<E, 1, false>(x, w, bias, gamma, beta, out, b,
                                             h, wd, cin, cout, ta, tb, mode,
                                             smem, st);
}

}  // namespace

// x (b, h, wd, cin) and out (b, 2h, 2wd, cout), float32, or bfloat16 where
// bf16 != 0; w (5, 5, cin, cout), bias (cout,), gamma (cout, cout) and beta
// (cout,) (ignored when mode == 0) float32; all contiguous. mode: 0 none,
// 1 IGDN, 2 GDN. splits == 1: the tiled kernel on ta x tb tiles; a tb that
// is a multiple of 4 runs 4 columns per thread, any other tb one; gamma_l2
// != 0 leaves gamma in global memory (ops/deconv_igdn.py:launch_plan picks
// it where gamma does not fit beside the tile). splits in {2, 4, 8}: the
// cluster split-K kernel on ta x tb tiles, ta == tb in {1, 2, 4}, cout a
// multiple of 4 up to 128, w, gamma and beta 16-byte aligned.
// Launches on `stream`; returns the launch's CUDA error (0 on success), or
// cudaErrorInvalidValue for a plan it has no kernel or shared memory for.
extern "C" int mmnc_deconv_igdn_forward(const void* x, const float* w,
                                        const float* bias, const float* gamma,
                                        const float* beta, void* out, int b,
                                        int h, int wd, int cin, int cout,
                                        int ta, int tb, int splits, int mode,
                                        int gamma_l2, int bf16,
                                        void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, splits, mode,
                                      gamma_l2, st);
  return launch_type<float>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                            cout, ta, tb, splits, mode, gamma_l2, st);
}
