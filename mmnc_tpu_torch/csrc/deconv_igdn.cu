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
// be cut finer, three ways:
//
// Tiled (deconv_igdn_tiled_kernel; every stage off the split kernel: the
// wide rgb stages, the 3-channel ones and the multi-task heads' narrow
// ones, Cout 1-21). A block owns one output-parity plane of a tile of
// TA x TB input positions with all Cout channels: an output pixel has one
// parity, and its (I)GDN needs only its own Cout channels, so the
// epilogue stays on chip while four blocks share a tile. Where Cout <= 4
// (one channel quad) a block owns the tile's four planes instead: there
// the work per plane is too small to pay for a block's set-up and its
// own copy of the input tile. What bounded the earlier kernel (one block
// per tile and all four parities; an __ldg of one weight per tap and
// input channel reused for 4 FMAs; one output channel per thread; staging
// before any FMA) and what this one does:
// - blocks: tiles are picked per shape (ops/deconv_igdn.py:tile_shape) so
//   that a launch has at least min(132, B x 4 x ceil(H W / 8)) blocks:
//   shared4's 16x16 -> 21 at batch 8 runs 256 blocks of 4x8 tiles, not 16.
//   While a launch has fewer than 32 warps an SM, a block's threads split
//   Cin into up to 16 slices whose partial sums are added in slice order
//   in shared memory (the 1x1-4x4 inputs at Cout 10 take 2-16);
// - weights: the taps of the block's planes that reach the image (9, 6, 6
//   or 4 a plane; 1 on a 1x1 input) for a chunk of Cin go into shared
//   memory by cp.async from a per-block tap table, every thread a share of
//   the (tap, Cin, copy) triples: 16 bytes a copy where Cout is a multiple
//   of 4 and w 16-byte aligned, 8 where Cout is even, else 4 (a (tap, Cin)
//   row of Cout floats starts aligned only so), each row padded to Cp = 4
//   ceil(Cout / 4) floats. Two stages (one where a chunk holds all of
//   Cin): chunk k + 1 is in flight while chunk k computes. The input tile
//   (+ 1-pixel halo, zero outside the image) and gamma (transposed,
//   gT[j][o], by the copies' addresses) come with chunk 0. Index
//   arithmetic is kept by adds: divisions per copy had cost more
//   instructions than the FMAs at 16x16 100 -> 50;
// - register tiles: a thread owns P (1-8) positions along a tile row x 4
//   output channels (1 where Cout is 1); per input channel and tap row it
//   reads the P + 2 inputs its 2-3 column taps share (broadcast) and a
//   float4 of weights per tap, for 4P FMAs a tap;
// - epilogue: pre-activations and their squares go to shared memory
//   (over the dead weight stages); a thread then takes the main loop's
//   positions x 4 channels, reads a float4 of gT and the positions' y^2
//   per input channel, and stores along the interleaved output's
//   channels. Four-plane blocks instead take one output pixel a thread in
//   row-major order, so a warp stores consecutive pixels (per-thread
//   positions 2 pixels apart cost a 32-byte sector a 4-byte value at
//   Cout 1), their y rows swizzled against bank conflicts.
// A thread's sum runs over chunks, then its slice's channels, then taps in
// kernel-index order; slices are added in order. Chunk, slices and P
// follow from the shape and tile alone (never the mode: shared memory is
// counted with gamma's room whatever the mode), so two launches are
// bitwise equal and a launch with gamma 0 and beta 1 reads back the same
// sums. ops/deconv_igdn.py:tiled_config mirrors the plan. What bounds it
// now: the FMA-heavy stages (128x128 17 -> 17, the 50-channel rgb ones)
// run at 11-17% of the CUDA cores' f32 rate, held back by a block's
// serial phases (stage, wait, compute, reduce, epilogue) at 2-3 blocks an
// SM; the small ones by a block's fixed latency.
//
// Tiled in L2 (deconv_igdn_l2_kernel): where gamma (Cout x Cout) and the
// stages do not fit in a block's shared memory beside any tile (Cout above
// about 225), one block per tile and all four parities, the weight
// streamed from L2 (__ldg, reused for kCols output pixels), gamma read by
// the epilogue through the read-only cache (360 KB at Cout = 300 stays in
// L2): correct at any width, not tuned.
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
// These three: plain FMAs, exact f32, no tensor cores (the port's exact-f32
// policy, device.py).
//
// bfloat16 activations (the bf16 model): x and out are bf16; the weights,
// bias, gamma and beta stay float32 (the layer hands over values rounded to
// bf16), so the weight staging and gamma's do not change. The three kernels
// widen x to float32 as they stage it (plain loads: a bf16 channel at an
// odd offset is not 4-byte aligned for cp.async, and the split stages'
// inputs are 1x1 to 4x4), sum in float32, and round y to bf16 before the
// epilogue as the unfused chain rounds it: the sum of products (the bf16
// conv's output), then that + the bias (the bf16 bias add); the output is
// rounded once more at the store. (Rounding sum + bias once instead
// differs from the chain's two roundings in a large share of y values, and
// the IGDN, which squares y, amplifies that difference.)
//
// Tiled on the tensor cores (deconv_igdn_mma_kernel; bf16 only, the plan
// "tiled_mma" in place of "tiled" where the tile's width is a multiple of
// 8 and Cout > 4). With bf16 x the CUDA-core kernel lost to cuDNN's bf16
// transposed conv, which runs on the tensor cores, at five stages by
// 1.1-2.8x. A product of a bf16 value of x and a weight holding a bf16
// value is exact in float32, so mma.sync.m16n8k16.f32.bf16.bf16.f32 changes
// only the order of the float32 sums, as cuDNN's does. The block is the
// tiled kernel's (image, tile, parity plane) and its sum an implicit GEMM:
// M = the tile's positions, N = Cout padded to 8 nt ng, K = the plane's
// taps x Cin padded to 16 (mma_plan: one m16 tile a warp, N split into ng
// groups of nt n8 tiles where the tile has few positions):
// - A: the input tile + halo in bf16, position-major [pixel][Cin padded +
//   8], rows an odd number of 16 bytes apart so that ldmatrix's 8 rows fall
//   in distinct banks. A halo row's pixels lie contiguous in x, so it is
//   read by 16-byte loads and each value stored at its pixel and channel
//   (2- and 4-byte copies a pixel were the slowest phase). A tap's A rows
//   are the halo pixels shifted by its offset, and ldmatrix.x4 takes a row
//   address a lane: no im2col copy.
// - B: the plane's weight taps for a chunk of Cin, converted to bf16 as
//   they are staged (__float2bfloat16_rn, exact: the weights hold bf16
//   values) and kept as the (tap, Cin, Cout) rows of w, [slot][c][N
//   padded], read by ldmatrix.x4.trans, two n8 tiles a load. cp.async
//   cannot convert, so a thread loads its (row, column pair) items of
//   chunk k + 1 into registers before chunk k's MMAs and stores them into
//   the other of two stages after them: the loads are in flight while the
//   tensor cores run. (Stages kept in float32, each lane packing its own
//   fragments, cost 4 loads and 2 conversions an MMA and were slower at
//   every rgb stage.)
// - pads: every pad of K and N reads zeros, never an unwritten word (NaN x
//   0 is NaN): a chunk's stores write its rows past Cin and its columns
//   past Cout as 0, and the input tile starts zeroed.
// - order: chunks, then taps in kernel-index order, then k16 steps; no
//   split of K between warps or blocks, no atomics, nothing set by the
//   mode: two launches are bitwise equal and a launch with gamma 0 and
//   beta 1 reads back the same sums.
// - epilogue: y (the sum rounded, + the bias, rounded) and y^2 go to shared
//   memory and the tiled kernel's one-plane (I)GDN runs on the CUDA cores
//   in float32 (plane_epilogue), y^2 skewed by 4 floats a position group
//   so that the groups a warp reads at once fall in distinct banks.
// What bounds it is not the MMAs: a block's staging, main loop and
// epilogue run one after the other, one block an SM at the rgb stages (two
// at shared4's 16x16 tiles), and every block stages the plane's whole
// weight. Staging the input tile, the chunks' round trips to L2 where Cin
// is large, and the epilogue's phase (not its FMAs) take most of a
// block's time; the stages run at 19-77x their bound, and 16x16 100 -> 50
// at batch 8 still loses to cuDNN (PERF.md §6). The plan's tiles give at least 128 blocks: every
// block stages the whole weight, so fewer, larger tiles won
// (ops/deconv_igdn.py:mma_tile_shape).

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

// ---- copies, barriers and tap geometry ----------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// 8 bytes; both ends 8-byte aligned.
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// 16 bytes; both ends 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ---- tiled kernel -------------------------------------------------------

constexpr int kTiledMaxThreads = 256;
constexpr int kMaxSlices = 16;      // Cin slices of a tiled block
// Threads a tiled launch aims for: 32 warps an SM on the H100's 132 SMs.
// Below that, Cin slices add threads to the blocks.
constexpr int kFillThreads = 132 * 1024;
constexpr int kMaxTiledChunk = 32;  // Cin channels per staged chunk
// Shared memory of a tiled block that leaves room for a second block on
// the SM (each block also holds 1 KB the system reserves).
constexpr int kHalfSmem = 112 * 1024;

// Taps t < 3 - d (kernel index 2t + d) of parity d that reach the image
// for the tile positions [p0, p0 + t) of an axis of length n: *t_lo and
// the count (contiguous: the tile and the image are intervals).
__host__ __device__ __forceinline__ int parity_taps(int d, int p0, int t,
                                                    int n, int* t_lo) {
  int count = 0;
  *t_lo = 0;
  for (int tt = 2 - d; tt >= 0; --tt) {
    if (tap_hits(2 * tt + d, p0, t, n)) {
      *t_lo = tt;
      ++count;
    }
  }
  return count;
}

// gamma transposed by the copies' addresses, gT[j cp + o] = gamma[o][j],
// and beta (cp floats), by cp.async.
__device__ __forceinline__ void stage_gamma(float* g_s, float* b_s,
                                            const float* gamma,
                                            const float* beta, int cout,
                                            int cp) {
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int o = tid / cout, j = tid - o * cout;
  const int o_by = nthreads / cout, j_by = nthreads - o_by * cout;
  for (int i = tid; i < cout * cout; i += nthreads) {
    cp_async4(g_s + j * cp + o, gamma + i);
    o += o_by;
    j += j_by;
    if (j >= cout) {
      j -= cout;
      ++o;
    }
  }
  for (int i = tid; i < cout; i += nthreads) cp_async4(b_s + i, beta + i);
}

// The epilogue of a block that owns one parity plane (dh, dw) of the
// ta x tb tile at (a0, b0): its y and y^2 in shared memory, y [position
// in row-major tile order][cp], y^2 of position p at p cp + (p / kP)
// skew, gT [j][cp] and beta (cp floats); item = (group of kP positions
// along a tile row, channel quad), as the tiled kernel's main loop: per
// input channel j one float4 of gT (4 output channels) and the group's kP
// values of y^2 for 4 kP FMAs. Stores run along an output pixel's
// channels. The norm sums over j in order from beta. (A group's y^2 rows
// lie kP cp floats, a multiple of 32 banks, from the next group's: a skew
// of 4 puts the groups a warp reads at once in distinct banks.)
template <typename E, int kP>
__device__ __forceinline__ void plane_epilogue(
    const float* y_s, const float* y2_s, const float* g_s, const float* b_s,
    E* __restrict__ out, int n, int h, int wd, int cout, int npos, int tb,
    int a0, int b0, int edh, int edw, int mode, int skew) {
  const int cq = (cout + 3) / 4, cp = 4 * cq;
  const int oh = 2 * h, ow = 2 * wd;
  for (int e = threadIdx.x; e < npos / kP * cq; e += blockDim.x) {
    const int eg = e / cq;
    const int o = 4 * (e - eg * cq);
    const int row = eg * kP / tb, col0 = eg * kP % tb;
    const int at = (row * tb + col0) * cp;
    const float* y2g = y2_s + at + eg * skew;
    float norm[kP][4];
    if (mode) {
      const float4 b4 = *reinterpret_cast<const float4*>(b_s + o);
#pragma unroll
      for (int i = 0; i < kP; ++i) {
        norm[i][0] = b4.x;
        norm[i][1] = b4.y;
        norm[i][2] = b4.z;
        norm[i][3] = b4.w;
      }
#pragma unroll 2
      for (int j = 0; j < cout; ++j) {
        const float4 g4 = *reinterpret_cast<const float4*>(g_s + j * cp + o);
#pragma unroll
        for (int i = 0; i < kP; ++i) {
          const float yy = y2g[i * cp + j];
          norm[i][0] = fmaf(g4.x, yy, norm[i][0]);
          norm[i][1] = fmaf(g4.y, yy, norm[i][1]);
          norm[i][2] = fmaf(g4.z, yy, norm[i][2]);
          norm[i][3] = fmaf(g4.w, yy, norm[i][3]);
        }
      }
    }
    const int ia = a0 + row;
    if (ia >= h) continue;
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int ib = b0 + col0 + i;
      if (ib >= wd) break;
      const float4 y4 = *reinterpret_cast<const float4*>(y_s + at + i * cp + o);
      const float v[4] = {y4.x, y4.y, y4.z, y4.w};
      E* dst = out + ((static_cast<long long>(n) * oh + 2 * ia + edh) * ow +
                      2 * ib + edw) * cout + o;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (o + j >= cout) break;
        float r = v[j];
        if (mode) r = (mode == 1) ? r * sqrtf(norm[i][j]) : r * rsqrtf(norm[i][j]);
        dst[j] = narrow<E>(r);
      }
    }
  }
}

// Grid (4 x tiles, B), or (tiles, B) where cout <= 4: block (tile, image)
// owns the parity planes q = 2 dh + dw of a ta x tb tile (q from the
// block, 4 tile + q, or, where Cout <= 4, all four planes, q from the
// thread: they share the input tile), all Cout channels. Threads: (slice,
// plane, position group, channel quad), quad fastest, rounded up to whole
// warps; see tiled_plan. Dynamic shared memory (floats), from offset 0:
// the weight stages, nv x chunk x cp each, two (one where a chunk holds
// all of Cin) (after the main loop the slices' partial sums, then y and
// y^2, planes x npos x cp each), then the input tile + halo [cin][ta +
// 2][tb + 2] (rounded up to 4 floats), gT [cout][cp], beta (cp floats).
// E: the activations' type. kP: positions a thread. kOne: Cout == 1 (one
// FMA a position, not four).
template <typename E, int kP, bool kOne>
__global__ void __launch_bounds__(kTiledMaxThreads)
deconv_igdn_tiled_kernel(const E* __restrict__ x, const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ gamma,
                         const float* __restrict__ beta, E* __restrict__ out,
                         int h, int wd, int cin, int cout, int ta, int tb,
                         int mode, int slices, int chunk, int nv) {
  extern __shared__ float4 smem4[];
  const int cq = (cout + 3) / 4, cp = 4 * cq;
  const int nq = cq == 1 ? 4 : 1;  // parity planes a block
  const int npos = ta * tb;
  const int wx = tb + 2, hw = (ta + 2) * wx;
  const int stage_floats = nv * chunk * cp;
  const int nchunks = (cin + chunk - 1) / chunk;
  const int stages = (nchunks > 1 ? 2 : 1) * stage_floats;
  const int ys = nq * npos * cp * (slices > 1 ? slices + 2 : 2);
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + (stages > ys ? stages : ys);
  float* g_s = x_s + (hw * cin + 3) / 4 * 4;  // gT[j * cp + o] = gamma[o][j]
  float* b_s = g_s + cout * cp;                // beta, cp floats

  const int tiles_w = (wd + tb - 1) / tb;
  const int tile = nq == 4 ? blockIdx.x : blockIdx.x >> 2;
  const int a0 = tile / tiles_w * ta, b0 = tile % tiles_w * tb;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;

  // The block's planes: parity, taps (t_lo.. nt, s_lo.. ns) and first slot
  // of each in a weight stage.
  int pq[4], pt_lo[4], pnt[4], ps_lo[4], pns[4], pslot[4];
  int ntaps = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    pq[u] = nq == 4 ? u : (blockIdx.x & 3);
    pnt[u] = parity_taps(pq[u] >> 1, a0, ta, h, &pt_lo[u]);
    pns[u] = parity_taps(pq[u] & 1, b0, tb, wd, &ps_lo[u]);
    pslot[u] = ntaps;
    ntaps += u < nq ? pnt[u] * pns[u] : 0;
  }
  // tap_s[slot]: offset in w of the slot's tap (kernel index kh * 5 + kw)
  // for Cin 0, slot = pslot[u] + (t - t_lo) ns + s - s_lo for plane u.
  __shared__ int tap_s[25];
  if (tid < ntaps) {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int local = tid - pslot[v];
      if (v < nq && local >= 0 && local < pnt[v] * pns[v]) {
        const int t = pt_lo[v] + local / pns[v], s = ps_lo[v] + local % pns[v];
        tap_s[tid] =
            ((2 * t + (pq[v] >> 1)) * 5 + 2 * s + (pq[v] & 1)) * cin * cout;
      }
    }
  }
  __syncthreads();
  // Copy width in floats: a (tap, Cin) row of w starts 16-byte aligned
  // only where Cout is a multiple of 4, 8-byte aligned where it is even.
  const unsigned long long wa = reinterpret_cast<unsigned long long>(w);
  const int width =
      cout % 4 == 0 && wa % 16 == 0 ? 4 : (cout % 2 == 0 && wa % 8 == 0 ? 2 : 1);
  const int row_copies = cout / width;

  // Chunk k of the weights, every tap the block's planes read:
  // w_s[k % 2][slot][c][o] = w[tap][k chunk + c][o]. Copy e = (slot, c,
  // o), e = tid, tid + nthreads, ...: (slot, c, o) kept by adds. Columns
  // cout..cp - 1 are left as they are: they feed only the padded
  // channels' sums, which are never stored.
  auto stage_chunk = [&](int k) {
    const int c0 = k * chunk;
    const int kc = cin - c0 < chunk ? cin - c0 : chunk;
    const int copies = kc * row_copies;  // of a slot, contiguous in w
    const int step_slot = nthreads / copies;
    const int step_r = nthreads - step_slot * copies;
    const int step_c = step_r / row_copies, step_o = step_r % row_copies;
    int slot = tid / copies, c = tid % copies / row_copies,
        o = tid % row_copies;
    float* dst = w_s + (k & 1) * stage_floats;
    for (; slot < ntaps;) {
      float* d = dst + (slot * chunk + c) * cp + o * width;
      const float* src = w + tap_s[slot] + (c0 + c) * cout + o * width;
      if (width == 4)
        cp_async16(d, src);
      else if (width == 2)
        cp_async8(d, src);
      else
        cp_async4(d, src);
      o += step_o;
      c += step_c;
      slot += step_slot;
      if (o >= row_copies) {
        o -= row_copies;
        ++c;
      }
      if (c >= kc) {
        c -= kc;
        ++slot;
      }
    }
  };

  // Group 0: chunk 0, gamma (transposed by the copies' addresses) and
  // beta, and in float32 the input tile.
  stage_chunk(0);
  if (mode) stage_gamma(g_s, b_s, gamma, beta, cout, cp);
  // The input tile + halo, zero outside the image: x_s[ci][r][c] =
  // x[n][a0 - 1 + r][b0 - 1 + c][ci], element i = (r wx + c) cin + ci read
  // along i (coalesced), (ci, r, c) kept by adds. float32 by cp.async;
  // bf16 widened by plain loads, 16 in flight a thread (a bf16 channel at
  // an odd offset is not 4-byte aligned for cp.async).
  const int xn = hw * cin;
  const int p_step = nthreads / cin, ci_step = nthreads - p_step * cin;
  const int r_step = p_step / wx, col_step = p_step - r_step * wx;
  int ci = tid % cin, r = tid / cin / wx, col = tid / cin % wx;
  auto next_x = [&]() {
    ci += ci_step;
    const int carry = ci >= cin;
    ci -= carry ? cin : 0;
    col += col_step + carry;
    r += r_step;
    if (col >= wx) {
      col -= wx;
      ++r;
    }
  };
  auto x_src = [&]() -> long long {  // -1 outside the image
    const int ia = a0 - 1 + r, ib = b0 - 1 + col;
    return ia >= 0 && ia < h && ib >= 0 && ib < wd
               ? ((static_cast<long long>(n) * h + ia) * wd + ib) * cin + ci
               : -1;
  };
  if constexpr (std::is_same<E, float>::value) {
    for (int i = tid; i < xn; i += nthreads) {
      const long long src = x_src();
      float* dst = x_s + ci * hw + r * wx + col;
      if (src >= 0)
        cp_async4(dst, x + src);
      else
        *dst = 0.f;
      next_x();
    }
    cp_async_commit();
  } else {
    cp_async_commit();
    constexpr int kBatch = 16;
    for (int i0 = tid; i0 < xn; i0 += kBatch * nthreads) {
      float v[kBatch];
      int dst[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        dst[u] = -1;
        v[u] = 0.f;
        if (i0 + u * nthreads < xn) {
          const long long src = x_src();
          dst[u] = ci * hw + r * wx + col;
          if (src >= 0) v[u] = widen(x[src]);
          next_x();
        }
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u)
        if (dst[u] >= 0) x_s[dst[u]] = v[u];
    }
  }

  // thread = (slice, plane u, position group g, channel quad qd), qd
  // fastest: a warp's threads read one broadcast input value per position
  // and consecutive float4s of weights. Group g: the kP positions g kP.. of
  // the tile's row-major order, along one tile row (tb is a multiple of
  // kP).
  const int base = npos / kP * cq;  // (group, quad) threads of a plane
  const int slice = tid / (nq * base), rem = tid - slice * nq * base;
  const int u = rem / base, g = (rem - u * base) / cq;
  const int qd = rem - u * base - g * cq;
  const bool active = slice < slices;
  int dh = 0, dw = 0, t_lo = 0, nt = 0, s_lo = 0, ns = 0, slot0 = 0;
#pragma unroll
  for (int v = 0; v < 4; ++v) {
    if (v == u) {
      dh = pq[v] >> 1;
      dw = pq[v] & 1;
      t_lo = pt_lo[v];
      nt = pnt[v];
      s_lo = ps_lo[v];
      ns = pns[v];
      slot0 = pslot[v];
    }
  }
  const int xoff = g * kP / tb * wx + g * kP % tb;
  float bv[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    bv[j] = 4 * qd + j < cout ? __ldg(bias + 4 * qd + j) : 0.f;
  float acc[kP][4];
#pragma unroll
  for (int i = 0; i < kP; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j] = slices == 1 ? acc_start<E>(bv[j]) : 0.f;

  // Per channel c and tap row t the group's row of kP + ns - 1 inputs is
  // read once and serves the ns column taps: kP + 2 loads and ns float4s
  // of weights for 4 kP ns FMAs. Where ns < 3 the last load (at most one
  // float past the tile row; the tile is followed by gT in shared memory)
  // feeds no FMA; loading it unconditionally was 4-6% faster than a
  // predicated load on the H100.
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) {
      stage_chunk(k + 1);  // its stage was last read before the last sync
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const int c0 = k * chunk;
      const int kc = cin - c0 < chunk ? cin - c0 : chunk;
      const float* ws =
          w_s + (k & 1) * stage_floats + slot0 * chunk * cp + 4 * qd;
      const float* xs = x_s + c0 * hw + (t_lo + dh) * wx + s_lo + dw + xoff;
#pragma unroll 2
      for (int c = slice; c < kc; c += slices) {
        const float* xc = xs + c * hw;
        const float* wc = ws + c * cp;
        for (int ti = 0; ti < nt; ++ti) {
          float xr[kP + 2];
#pragma unroll
          for (int i = 0; i < kP + 2; ++i)
            xr[i] = xc[ti * wx + i];
#pragma unroll
          for (int si = 0; si < 3; ++si) {
            if (si < ns && kOne) {
              const float wv = wc[(ti * ns + si) * chunk * cp];
#pragma unroll
              for (int i = 0; i < kP; ++i)
                acc[i][0] = fmaf(xr[si + i], wv, acc[i][0]);
            } else if (si < ns) {
              const float4 wv = *reinterpret_cast<const float4*>(
                  wc + (ti * ns + si) * chunk * cp);
#pragma unroll
              for (int i = 0; i < kP; ++i) {
                acc[i][0] = fmaf(xr[si + i], wv.x, acc[i][0]);
                acc[i][1] = fmaf(xr[si + i], wv.y, acc[i][1]);
                acc[i][2] = fmaf(xr[si + i], wv.z, acc[i][2]);
                acc[i][3] = fmaf(xr[si + i], wv.w, acc[i][3]);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // this stage is refilled two chunks later
  }

  // y and y^2 over the dead stages, [plane][position][cp]: with one slice
  // each thread writes its own; with more, the slices' partial sums first,
  // then bias + slice 0 + slice 1 + ... in order for each (plane,
  // position, quad).
  // Row (plane, position) of y; with four planes of one channel quad and
  // kP = 8 a warp's threads own rows 8 apart, so rows swap within groups
  // of 8 (row ^ (row / 8 % 8)) and their float4s fall in distinct banks.
  const bool swz = nq == 4 && kP == 8;
  auto yrow = [&](int row) { return swz ? row ^ ((row >> 3) & 7) : row; };
  const int planes = nq * npos * cp;
  float* y_s = w_s + (slices > 1 ? slices * planes : 0);
  float* y2_s = y_s + planes;
  if (active) {
#pragma unroll
    for (int i = 0; i < kP; ++i) {
      const int at = yrow(u * npos + g * kP + i) * cp + 4 * qd;
      if (slices == 1) {
        const float4 v = make_float4(pre_activation<E>(acc[i][0], bv[0]),
                                     pre_activation<E>(acc[i][1], bv[1]),
                                     pre_activation<E>(acc[i][2], bv[2]),
                                     pre_activation<E>(acc[i][3], bv[3]));
        *reinterpret_cast<float4*>(y_s + at) = v;
        *reinterpret_cast<float4*>(y2_s + at) =
            make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
      } else {
        *reinterpret_cast<float4*>(w_s + slice * planes + at) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
    }
  }
  if (slices > 1) {
    __syncthreads();
    for (int e = tid; e < nq * npos * cq; e += nthreads) {
      const int r0 = e / cq, o = 4 * (e - r0 * cq), row = yrow(r0);
      float b4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b4[j] = o + j < cout ? __ldg(bias + o + j) : 0.f;
      float4 v = make_float4(acc_start<E>(b4[0]), acc_start<E>(b4[1]),
                             acc_start<E>(b4[2]), acc_start<E>(b4[3]));
      for (int r = 0; r < slices; ++r) {
        const float4 part = *reinterpret_cast<const float4*>(
            w_s + r * planes + row * cp + o);
        v.x += part.x;
        v.y += part.y;
        v.z += part.z;
        v.w += part.w;
      }
      v = make_float4(pre_activation<E>(v.x, b4[0]),
                      pre_activation<E>(v.y, b4[1]),
                      pre_activation<E>(v.z, b4[2]),
                      pre_activation<E>(v.w, b4[3]));
      *reinterpret_cast<float4*>(y_s + row * cp + o) = v;
      *reinterpret_cast<float4*>(y2_s + row * cp + o) =
          make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
    }
  }
  __syncthreads();

  // epilogue; norm sums over the input channels j in order from beta.
  const int oh = 2 * h, ow = 2 * wd;
  if (nq == 4) {
    // Cout <= 4, four planes: item = output pixel of the tile in row-major
    // order, so a warp's stores are consecutive pixels.
    for (int e = tid; e < 4 * npos; e += nthreads) {
      const int py = e / (2 * tb), px = e - py * 2 * tb;
      const int ia = a0 + (py >> 1), ib = b0 + (px >> 1);
      if (ia >= h || ib >= wd) continue;
      const int at =
          yrow(((py & 1) * 2 + (px & 1)) * npos + (py >> 1) * tb + (px >> 1)) *
          4;
      const float4 y4 = *reinterpret_cast<const float4*>(y_s + at);
      const float4 s4 = *reinterpret_cast<const float4*>(y2_s + at);
      const float yv[4] = {y4.x, y4.y, y4.z, y4.w};
      const float y2v[4] = {s4.x, s4.y, s4.z, s4.w};
      E* dst = out + ((static_cast<long long>(n) * oh + 2 * a0 + py) * ow +
                      2 * b0 + px) * cout;
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        if (o >= cout) break;
        float r = yv[o];
        if (mode) {
          float norm = b_s[o];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (j < cout) norm = fmaf(g_s[j * 4 + o], y2v[j], norm);
          r = (mode == 1) ? r * sqrtf(norm) : r * rsqrtf(norm);
        }
        dst[o] = narrow<E>(r);
      }
    }
    return;
  }
  plane_epilogue<E, kP>(y_s, y2_s, g_s, b_s, out, n, h, wd, cout, npos, tb,
                        a0, b0, pq[0] >> 1, pq[0] & 1, mode, 0);
}

// ---- tiled kernel on the tensor cores (bf16) ------------------------------

constexpr int kMmaMaxWarps = 16;  // warps a block, at most
constexpr int kMmaMinWarps = 8;   // warps a block aims for (N groups)
constexpr int kMmaMaxNT = 8;      // n8 tiles a warp, at most
constexpr int kMmaP = 8;          // epilogue positions a thread
constexpr int kMmaItems = 2;  // (row, column pair) items a thread stages
// Blocks an SM a tensor-core kernel of kNT n8 tiles a warp and kItems
// staged items a thread is compiled for (__launch_bounds__): two
// 512-thread blocks (64 registers a thread) where its sums and staged
// weights are few.
template <int kNT, int kItems>
constexpr int mma_min_blocks() {
  return kNT <= 3 && kItems == 1 ? 2 : 1;
}
constexpr int kMmaSkew = 4;       // the epilogue's y^2 skew, floats a group

__device__ __forceinline__ void ldmatrix_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// Four 8x8 matrices, transposed: lane L gets rows 2 (L % 4), 2 (L % 4) + 1
// of column L / 4 of each.
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned addr,
                                                  unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(unsigned addr,
                                                  unsigned (&r)[2]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(addr));
}

// Two float32 values that hold bf16 values as one bf16x2 register: lo in
// the low half (the lower k of a fragment pair). Exact.
__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  union {
    __nv_bfloat162 v;
    unsigned u;
  } p;
  p.v = __floats2bfloat162_rn(lo, hi);
  return p.u;
}

// d += a (16 x 16, row) b (16 x 8, col): bf16 products, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid (4 x tiles, B): block (4 tile + q, image) owns parity plane q = 2 dh
// + dw of a ta x tb tile (tb a multiple of 8) with all Cout channels, as
// the tiled kernel's one-plane blocks. The plane's sum is an implicit GEMM:
// M = the tile's positions (row-major), N = Cout padded to np = 8 kNT ng,
// K = the plane's taps x Cin padded to kx = 16 ceil(Cin / 16). Warp (mi,
// ni), ni fastest, owns the m16 tile of positions 16 mi.. and the kNT n8
// tiles of channels 8 kNT ni..; see mma_plan. Dynamic shared memory (bytes
// from 0): the weight stages in bf16, [slot][chunk][nb] (two, one where a
// chunk holds all of Cin; after the main loop y and y^2 in float32, y
// [position][cp], y^2 skewed), the input tile + halo in bf16 [pixel][kx +
// 8], gT [cout][cp] and beta (cp) in float32. kItems: the staged (row,
// column pair) items a thread, mma_plan's items.
template <int kNT, int kItems>
__global__ void __launch_bounds__(kMmaMaxWarps * 32,
                                  mma_min_blocks<kNT, kItems>())
deconv_igdn_mma_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ w,
                       const float* __restrict__ bias,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       __nv_bfloat16* __restrict__ out, int h, int wd,
                       int cin, int cout, int ta, int tb, int mode, int ng,
                       int chunk, int nv) {
  extern __shared__ float4 smem4[];
  const int cp = (cout + 3) / 4 * 4;
  const int npos = ta * tb;
  const int wx = tb + 2, hw = (ta + 2) * wx;
  const int np = 8 * kNT * ng;
  const int nb = np + ((np / 8) % 2 ? 0 : 8);  // stage row, bf16: odd x 16 B
  const int kx = (cin + 15) / 16 * 16;          // K of a tap, Cin padded
  const int xs = kx + 8;  // tile row, bf16: an odd number of 16 bytes
  const int stage_elems = nv * chunk * nb;
  const int nchunks = (cin + chunk - 1) / chunk;
  const int stage_bytes = (nchunks > 1 ? 2 : 1) * stage_elems * 2;
  const int y_bytes = 4 * (2 * npos * cp + npos / kMmaP * kMmaSkew);
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  __nv_bfloat16* w_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* x_s = reinterpret_cast<__nv_bfloat16*>(
      smem + (stage_bytes > y_bytes ? stage_bytes : y_bytes));
  float* g_s = reinterpret_cast<float*>(x_s + hw * xs);  // gT[j cp + o]
  float* b_s = g_s + cout * cp;                          // beta, cp floats

  const int tiles_w = (wd + tb - 1) / tb;
  const int tile = blockIdx.x >> 2, q = blockIdx.x & 3;
  const int dh = q >> 1, dw = q & 1;
  const int a0 = tile / tiles_w * ta, b0 = tile % tiles_w * tb;
  const int n = blockIdx.y;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  int t_lo, s_lo;
  const int nt = parity_taps(dh, a0, ta, h, &t_lo);
  const int ns = parity_taps(dw, b0, tb, wd, &s_lo);
  const int ntaps = nt * ns;
  // tap_s[slot]: offset in w of tap (t, s) = (t_lo + slot / ns, s_lo +
  // slot % ns), kernel index (2t + dh) * 5 + 2s + dw, for Cin 0.
  __shared__ int tap_s[9];
  if (tid < ntaps)
    tap_s[tid] = ((2 * (t_lo + tid / ns) + dh) * 5 + 2 * (s_lo + tid % ns) +
                  dw) * cin * cout;
  // The input tile starts zeroed: pixels outside the image and channels
  // Cin.. kx - 1 stay so (a pad of K reads 0, never an unwritten word).
  for (int i = tid; i < hw * xs / 8; i += nthreads)
    reinterpret_cast<uint4*>(x_s)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // The weight stages, through registers: item e = (row c, column pair o2)
  // of a chunk, e = tid, tid + nthreads (at most kItems a thread), over
  // every tap slot: w_s[k % 2][slot][c][2 o2 + i] = w[tap][k chunk + c][2
  // o2 + i] rounded to bf16 (exact: the weights hold bf16 values), 0 past
  // Cin and past Cout. Every word a chunk's MMAs read is written, pads
  // included (NaN x 0 is NaN). A chunk's loads go out before the previous
  // chunk's MMAs, their stores after them.
  const int pairs = np / 2;
  const bool wide = cout % 2 == 0 &&
                    reinterpret_cast<unsigned long long>(w) % 8 == 0;
  float2 wv[kItems][9];
  auto load_chunk = [&](int k) {
    const int c0 = k * chunk;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * nthreads;
      const int c = e / pairs, o = 2 * (e - c * pairs);
      const bool live = c < chunk && c0 + c < cin && o < cout;
      const float* src = w + (c0 + c) * cout + o;
#pragma unroll
      for (int slot = 0; slot < 9; ++slot) {
        wv[it][slot] = make_float2(0.f, 0.f);
        if (slot < ntaps && live) {
          if (wide) {
            wv[it][slot] =
                __ldg(reinterpret_cast<const float2*>(src + tap_s[slot]));
          } else {
            wv[it][slot].x = __ldg(src + tap_s[slot]);
            if (o + 1 < cout) wv[it][slot].y = __ldg(src + tap_s[slot] + 1);
          }
        }
      }
    }
  };
  auto store_chunk = [&](int k) {
    unsigned* dst = reinterpret_cast<unsigned*>(w_s + (k & 1) * stage_elems);
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int e = tid + it * nthreads;
      const int c = e / pairs, o2 = e - c * pairs;
      if (c < chunk) {
#pragma unroll
        for (int slot = 0; slot < 9; ++slot)
          if (slot < ntaps)
            dst[((slot * chunk + c) * nb) / 2 + o2] =
                bf16x2(wv[it][slot].x, wv[it][slot].y);
      }
    }
  };
  load_chunk(0);
  if (mode) stage_gamma(g_s, b_s, gamma, beta, cout, cp);
  // The input tile + halo: x_s[r wx + col][c] = x[n][a0 - 1 + r][b0 - 1 +
  // col][c] for the pixels in the image. A halo row's pixels in the image
  // lie contiguous in x: item (r, j) loads the row's j-th 16-byte aligned
  // chunk (the first and the last may reach up to 15 bytes past the row:
  // an aligned 16-byte load that holds a byte of x stays within x's mapped
  // pages) and stores its 2-byte values that belong to the row at their
  // pixel and channel, kXBatch chunks in flight a thread. (2- and 4-byte
  // copies of a pixel's channels were the slowest phase of the kernel.)
  const int ib_lo = b0 > 0 ? b0 - 1 : 0;
  const int ib_hi = b0 + tb + 1 < wd ? b0 + tb + 1 : wd;
  const int row_elems = (ib_hi - ib_lo) * cin;   // of a halo row, in x
  const int col_lo = ib_lo - (b0 - 1);           // its first pixel's column
  const int row_chunks = row_elems / 8 + 2;      // 16-byte chunks, at most
  const int x_items = (ta + 2) * row_chunks;
  const unsigned long long xa = reinterpret_cast<unsigned long long>(x);
  constexpr int kXBatch = 4;
  for (int i0 = tid; i0 < x_items; i0 += kXBatch * nthreads) {
    uint4 v[kXBatch];
    int row[kXBatch], off[kXBatch];
#pragma unroll
    for (int b = 0; b < kXBatch; ++b) {
      const int i = i0 + b * nthreads;
      row[b] = -1;
      const int r = i / row_chunks, ia = a0 - 1 + r;
      if (i < x_items && ia >= 0 && ia < h) {
        const unsigned long long start =
            xa + 2ull * ((static_cast<unsigned long long>(n) * h + ia) * wd +
                         ib_lo) * cin;
        const unsigned long long at = (start & ~15ull) + 16ull * (i - r *
                                                                  row_chunks);
        if (at < start + 2ull * row_elems) {
          v[b] = __ldg(reinterpret_cast<const uint4*>(at));
          row[b] = r;
          off[b] = static_cast<int>(static_cast<long long>(at - start) / 2);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < kXBatch; ++b) {
      if (row[b] < 0) continue;
      const unsigned words[4] = {v[b].x, v[b].y, v[b].z, v[b].w};
      const int e0 = off[b] > 0 ? off[b] : 0;
      int pix = e0 / cin, ch = e0 - pix * cin;
      unsigned short* dst = reinterpret_cast<unsigned short*>(x_s) +
                            (row[b] * wx + col_lo) * xs;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int e = off[b] + k;
        if (e >= e0 && e < row_elems) {
          dst[pix * xs + ch] =
              static_cast<unsigned short>(words[k >> 1] >> (16 * (k & 1)));
          if (++ch == cin) {
            ch = 0;
            ++pix;
          }
        }
      }
    }
  }

  store_chunk(0);
  cp_async_wait_all();  // gamma
  __syncthreads();

  // Fragments (mma.m16n8k16): A from the tile by ldmatrix.x4, lane L giving
  // the row address of position 16 mi + L % 16 (clamped to the tile; rows
  // past it are not stored) at channel 8 (L / 16); B from the stage by
  // ldmatrix.x4.trans, two n8 tiles at a time, lane L giving the address
  // of row L % 8 + 8 (L / 8 % 2) of n8 tile L / 16 (x2 for a last odd
  // tile); the sums in float32 registers, (rows g, g + 8) x (columns 2t, 2t
  // + 1) of each n8 tile, (g, t) = (L / 4, L % 4). For tap (t, s) of the
  // plane, the A row of position (pa, pb) is halo pixel (pa + t + dh) wx +
  // pb + s + dw.
  const int warp = tid >> 5, lane = tid & 31;
  const int mi = warp / ng, ni = warp - mi * ng;
  const int g = lane >> 2, t4 = lane & 3;
  int p = 16 * mi + (lane & 15);
  p = p < npos ? p : npos - 1;
  const unsigned a_lane =
      smem_addr(x_s + ((p / tb + t_lo + dh) * wx + p % tb + s_lo + dw) * xs +
                (lane >> 4) * 8);
  const unsigned b_lane = smem_addr(
      w_s + ((lane & 7) + 8 * ((lane >> 3) & 1)) * nb + 8 * kNT * ni +
      8 * (lane >> 4));
  float bv[kNT][2];  // the bias of the lane's sums' columns, 0 past Cout
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int o = 8 * (kNT * ni + j) + 2 * t4 + i;
      bv[j][i] = o < cout ? __ldg(bias + o) : 0.f;
    }
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = acc_start<__nv_bfloat16>(0.f);

  // K in a fixed order: chunks, then taps in kernel-index order, then k16
  // steps; no split of K between warps or blocks.
  for (int k = 0; k < nchunks; ++k) {
    if (k + 1 < nchunks) load_chunk(k + 1);
    const int c0 = k * chunk;
    const int steps = (kx - c0 < chunk ? kx - c0 : chunk) / 16;
    const unsigned b_stage = b_lane + (k & 1) * stage_elems * 2;
    for (int ti = 0; ti < nt; ++ti) {
      for (int si = 0; si < ns; ++si) {
        const unsigned a_tap = a_lane + ((ti * wx + si) * xs + c0) * 2;
        const unsigned b_tap = b_stage + (ti * ns + si) * chunk * nb * 2;
        for (int kk = 0; kk < steps; ++kk) {
          unsigned a[4];
          ldmatrix_x4(a_tap + kk * 32, a);
          const unsigned b16 = b_tap + kk * 16 * nb * 2;
#pragma unroll
          for (int j = 0; j + 1 < kNT; j += 2) {
            unsigned b[4];
            ldmatrix_x4_trans(b16 + j * 16, b);
            mma_bf16(acc[j], a, b[0], b[1]);
            mma_bf16(acc[j + 1], a, b[2], b[3]);
          }
          if (kNT % 2) {
            unsigned b[2];
            ldmatrix_x2_trans(b16 + (kNT - 1) * 16, b);
            mma_bf16(acc[kNT - 1], a, b[0], b[1]);
          }
        }
      }
    }
    if (k + 1 < nchunks) store_chunk(k + 1);  // last read before the last sync
    __syncthreads();
  }

  // y (the sum rounded, plus the bias, rounded) and y^2 over the dead
  // stages, [position][cp]; then the one-plane epilogue on the CUDA cores.
  float* y_s = reinterpret_cast<float*>(smem);
  float* y2_s = y_s + npos * cp;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    const int o0 = 8 * (kNT * ni + j) + 2 * t4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int pos = 16 * mi + g + 8 * (i >> 1), o = o0 + (i & 1);
      if (pos < npos && o < cp) {
        const float v = pre_activation<__nv_bfloat16>(acc[j][i], bv[j][i & 1]);
        y_s[pos * cp + o] = v;
        y2_s[pos * cp + pos / kMmaP * kMmaSkew + o] = v * v;
      }
    }
  }
  __syncthreads();
  plane_epilogue<__nv_bfloat16, kMmaP>(y_s, y2_s, g_s, b_s, out, n, h, wd,
                                       cout, npos, tb, a0, b0, dh, dw, mode,
                                       kMmaSkew);
}

// ---- tiled kernel with gamma in L2 --------------------------------------

// E: the activations' type. kCols: input columns (same parity) per thread,
// 4 or, for tiles narrower than 4, 1.
template <typename E, int kCols>
__global__ void __launch_bounds__(kThreads)
deconv_igdn_l2_kernel(const E* __restrict__ x, const float* __restrict__ w,
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
  float* b_s = y_s + pix * cout;          // cout

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
  if (mode)
    for (int i = threadIdx.x; i < cout; i += blockDim.x) b_s[i] = beta[i];
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
        norm = fmaf(__ldg(gr + j), yj * yj, norm);
      }
      v = (mode == 1) ? v * sqrtf(norm) : v * rsqrtf(norm);
    }
    out[((static_cast<long long>(n) * oh + gy) * ow + gx) * cout + o] =
        narrow<E>(v);
  }
}

// ---- split kernel -----------------------------------------------------

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

// Most taps parity d of a tile of t positions reads along an axis of
// length n, over the tiles.
int max_parity_taps(int n, int t, int d) {
  int best = 0, lo;
  for (int p0 = 0; p0 < n; p0 += t) {
    const int count = parity_taps(d, p0, t, n, &lo);
    best = count > best ? count : best;
  }
  return best;
}

// The tiled kernel's plan for ta x tb tiles (ops/deconv_igdn.py:
// tiled_config mirrors it); threads == 0 where none fits.
struct TiledPlan {
  int p;       // positions a thread, along a tile row: the largest of 8,
               // 4, 2, 1 that divides tb and leaves at least one warp of
               // threads
  int slices;  // Cin slices: doubled while the launch has fewer than
               // kFillThreads threads, the block stays within 256 and a
               // slice keeps 4 channels, up to 16
  int chunk;   // Cin channels a stage: the largest of min(Cin, 32), 16, 8
               // (not below min(Cin, 8)) that fits kHalfSmem, else the
               // largest of those, 4, 2, 1 that fits kMaxSmem
  int nv;      // weight rows of a stage: the most taps a block's planes read
  int threads;
  int smem_floats;
};

int tiled_smem_floats(int ta, int tb, int cin, int cout, int nv, int slices,
                      int chunk) {
  const int cp = (cout + 3) / 4 * 4, npos = ta * tb;
  const int nq = cp == 4 ? 4 : 1;
  const int stages = (chunk < cin ? 2 : 1) * nv * chunk * cp;
  const int ys = nq * npos * cp * (slices > 1 ? slices + 2 : 2);
  return (stages > ys ? stages : ys) + ((ta + 2) * (tb + 2) * cin + 3) / 4 * 4 +
         cout * cp + cp;
}

TiledPlan tiled_plan(int b, int h, int wd, int cin, int cout, int ta,
                     int tb) {
  TiledPlan plan = {};
  if (ta < 1 || tb < 1 || cin < 1 || cout < 1) return plan;
  const int npos = ta * tb, cq = (cout + 3) / 4;
  const int nq = cq == 1 ? 4 : 1;  // parity planes a block
  int p = 8;
  while (p > 1 && (tb % p || nq * npos / p * cq < 32)) p /= 2;
  const int base = nq * npos / p * cq;
  if (base > kTiledMaxThreads) return plan;
  const long long blocks =
      4LL / nq * b * ((h + ta - 1) / ta) * ((wd + tb - 1) / tb);
  int slices = 1;
  while (blocks * slices * base < kFillThreads && 2 * slices <= kMaxSlices &&
         2 * slices * base <= kTiledMaxThreads && 8 * slices <= cin)
    slices *= 2;
  // rows of the planes of one block (4) or of any one plane (1)
  int nv = 0;
  for (int q = 0; q < 4; ++q) {
    const int taps =
        max_parity_taps(h, ta, q >> 1) * max_parity_taps(wd, tb, q & 1);
    nv = nq == 4 ? nv + taps : (taps > nv ? taps : nv);
  }
  const int first = cin < kMaxTiledChunk ? cin : kMaxTiledChunk;
  const int least = cin < 8 ? cin : 8;
  const int sizes[6] = {first, 16, 8, 4, 2, 1};
  int chunk = 0;
  for (int pass = 0; pass < 2 && !chunk; ++pass)
    for (int i = 0; i < 6 && !chunk; ++i) {
      const int c = sizes[i];
      if (c > first || (pass == 0 && c < least)) continue;
      const long long bytes =
          4LL * tiled_smem_floats(ta, tb, cin, cout, nv, slices, c);
      if (bytes <= (pass == 0 ? kHalfSmem : kMaxSmem)) chunk = c;
    }
  if (!chunk) return plan;
  plan.p = p;
  plan.slices = slices;
  plan.chunk = chunk;
  plan.nv = nv;
  plan.threads = (slices * base + 31) / 32 * 32;
  plan.smem_floats = tiled_smem_floats(ta, tb, cin, cout, nv, slices, chunk);
  return plan;
}

template <typename E, int kP, bool kOne>
cudaError_t tiled_ready() {
  static const cudaError_t err =
      allow_max_smem(deconv_igdn_tiled_kernel<E, kP, kOne>);
  return err;
}

template <typename E, int kP, bool kOne>
int launch_tiled(const void* x, const float* w, const float* bias,
                 const float* gamma, const float* beta, void* out, int b,
                 int h, int wd, int cin, int cout, int ta, int tb, int mode,
                 const TiledPlan& plan, cudaStream_t st) {
  const cudaError_t ready = tiled_ready<E, kP, kOne>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int tiles = ((h + ta - 1) / ta) * ((wd + tb - 1) / tb);
  const dim3 grid((cout <= 4 ? 1 : 4) * tiles, b);
  deconv_igdn_tiled_kernel<E, kP, kOne>
      <<<grid, plan.threads, plan.smem_floats * sizeof(float), st>>>(
          static_cast<const E*>(x), w, bias, gamma, beta, static_cast<E*>(out),
          h, wd, cin, cout, ta, tb, mode, plan.slices, plan.chunk, plan.nv);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, bool kOne>
int launch_tiled_p(const void* x, const float* w, const float* bias,
                   const float* gamma, const float* beta, void* out, int b,
                   int h, int wd, int cin, int cout, int ta, int tb, int mode,
                   const TiledPlan& plan, cudaStream_t st) {
  switch (plan.p) {
    case 8:
      return launch_tiled<E, 8, kOne>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, mode, plan, st);
    case 4:
      return launch_tiled<E, 4, kOne>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, mode, plan, st);
    case 2:
      return launch_tiled<E, 2, kOne>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, mode, plan, st);
    default:
      return launch_tiled<E, 1, kOne>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, mode, plan, st);
  }
}

// The tensor-core kernel's plan for ta x tb tiles (ops/deconv_igdn.py:
// tiled_mma_config mirrors it); threads == 0 where none fits.
struct MmaPlan {
  int nt;      // n8 tiles a warp: ceil(ceil(Cout / 8) / ng)
  int ng;      // N groups: the fewest (with at most kMmaMaxNT n8 tiles a
               // warp) that give the block kMmaMinWarps warps, less any
               // that nt n8 tiles a group leave wholly past Cout
  int chunk;   // Cin channels a stage, a multiple of 16: the largest, from
               // kx down, whose (row, column pair) items come to at most
               // kMmaItems a thread and that fits kHalfSmem, else kMaxSmem
  int nv;      // weight rows of a stage: the most taps a plane reads
  int threads;  // 32 x ceil(ta tb / 16) x ng
  int items;    // staged (row, column pair) items a thread: 1 or 2
  int smem_bytes;
};

int mma_smem_bytes(int ta, int tb, int cin, int cout, int np, int nv,
                   int chunk) {
  const int cp = (cout + 3) / 4 * 4;
  const int nb = np + ((np / 8) % 2 ? 0 : 8);
  const int stages = 2 * (chunk < cin ? 2 : 1) * nv * chunk * nb;
  const int ys = 4 * (2 * ta * tb * cp + ta * tb / kMmaP * kMmaSkew);
  return (stages > ys ? stages : ys) +
         2 * (ta + 2) * (tb + 2) * ((cin + 15) / 16 * 16 + 8) +
         4 * (cout * cp + cp);
}

MmaPlan mma_plan(int h, int wd, int cin, int cout, int ta, int tb) {
  MmaPlan plan = {};
  if (ta < 1 || tb < 1 || tb % 8 || cin < 1 || cout <= 4) return plan;
  const int mt = (ta * tb + 15) / 16, ntiles = (cout + 7) / 8;
  int ng = (ntiles + kMmaMaxNT - 1) / kMmaMaxNT;
  while (mt * ng < kMmaMinWarps && ng < ntiles) ++ng;
  const int nt = (ntiles + ng - 1) / ng;
  ng = (ntiles + nt - 1) / nt;  // no group wholly past Cout
  if (mt * ng > kMmaMaxWarps) return plan;
  int nv = 0;
  for (int q = 0; q < 4; ++q) {
    const int taps =
        max_parity_taps(h, ta, q >> 1) * max_parity_taps(wd, tb, q & 1);
    nv = taps > nv ? taps : nv;
  }
  const int kx = (cin + 15) / 16 * 16;
  const int threads = 32 * mt * ng;
  int chunk = 0;
  for (int pass = 0; pass < 2 && !chunk; ++pass)
    for (int c = kx; c >= 16 && !chunk; c -= 16)
      if (c * 4 * nt * ng <= kMmaItems * threads &&
          mma_smem_bytes(ta, tb, cin, cout, 8 * nt * ng, nv, c) <=
              (pass == 0 ? kHalfSmem : kMaxSmem))
        chunk = c;
  if (!chunk) return plan;
  plan.nt = nt;
  plan.ng = ng;
  plan.chunk = chunk;
  plan.nv = nv;
  plan.threads = threads;
  plan.items = (chunk * 4 * nt * ng + threads - 1) / threads;
  plan.smem_bytes = mma_smem_bytes(ta, tb, cin, cout, 8 * nt * ng, nv, chunk);
  return plan;
}

template <int kNT, int kItems>
cudaError_t mma_ready() {
  static const cudaError_t err =
      allow_max_smem(deconv_igdn_mma_kernel<kNT, kItems>);
  return err;
}

template <int kNT, int kItems>
int launch_mma_items(const void* x, const float* w, const float* bias,
                     const float* gamma, const float* beta, void* out, int b,
                     int h, int wd, int cin, int cout, int ta, int tb,
                     int mode, const MmaPlan& plan, cudaStream_t st) {
  const cudaError_t ready = mma_ready<kNT, kItems>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const int tiles = ((h + ta - 1) / ta) * ((wd + tb - 1) / tb);
  deconv_igdn_mma_kernel<kNT, kItems>
      <<<dim3(4 * tiles, b), plan.threads, plan.smem_bytes, st>>>(
          static_cast<const __nv_bfloat16*>(x), w, bias, gamma, beta,
          static_cast<__nv_bfloat16*>(out), h, wd, cin, cout, ta, tb, mode,
          plan.ng, plan.chunk, plan.nv);
  return static_cast<int>(cudaGetLastError());
}

template <int kNT>
int launch_mma_nt(const void* x, const float* w, const float* bias,
                  const float* gamma, const float* beta, void* out, int b,
                  int h, int wd, int cin, int cout, int ta, int tb, int mode,
                  const MmaPlan& plan, cudaStream_t st) {
  if (plan.items == 1)
    return launch_mma_items<kNT, 1>(x, w, bias, gamma, beta, out, b, h, wd,
                                    cin, cout, ta, tb, mode, plan, st);
  return launch_mma_items<kNT, kMmaItems>(x, w, bias, gamma, beta, out, b, h,
                                          wd, cin, cout, ta, tb, mode, plan,
                                          st);
}

int launch_mma(const void* x, const float* w, const float* bias,
               const float* gamma, const float* beta, void* out, int b, int h,
               int wd, int cin, int cout, int ta, int tb, int mode,
               cudaStream_t st) {
  const MmaPlan plan = mma_plan(h, wd, cin, cout, ta, tb);
  switch (plan.threads ? plan.nt : 0) {
    case 1:
      return launch_mma_nt<1>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 2:
      return launch_mma_nt<2>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 3:
      return launch_mma_nt<3>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 4:
      return launch_mma_nt<4>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 5:
      return launch_mma_nt<5>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 6:
      return launch_mma_nt<6>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 7:
      return launch_mma_nt<7>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    case 8:
      return launch_mma_nt<8>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                              cout, ta, tb, mode, plan, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename E, int kCols>
cudaError_t l2_ready() {
  static const cudaError_t err =
      allow_max_smem(deconv_igdn_l2_kernel<E, kCols>);
  return err;
}

template <typename E, int kCols>
int launch_l2(const void* x, const float* w, const float* bias,
              const float* gamma, const float* beta, void* out, int b, int h,
              int wd, int cin, int cout, int ta, int tb, int mode, size_t smem,
              cudaStream_t st) {
  const cudaError_t ready = l2_ready<E, kCols>();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  const dim3 grid((wd + tb - 1) / tb, (h + ta - 1) / ta, b);
  deconv_igdn_l2_kernel<E, kCols><<<grid, kThreads, smem, st>>>(
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
                int mode, int variant, cudaStream_t st) {
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
  if (variant == 2) {
    if (std::is_same<E, float>::value)  // exact f32: not on the tensor cores
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x, w, bias, gamma, beta, out, b, h, wd, cin, cout, ta,
                      tb, mode, st);
  }
  if (variant == 1) {
    // ops/deconv_igdn.py:l2_smem_bytes mirrors this
    const size_t floats = static_cast<size_t>((ta + 2) * (tb + 2) * cin) +
                          static_cast<size_t>(4 * ta * tb * cout) +
                          (mode ? static_cast<size_t>(cout) : 0);
    const size_t smem = floats * sizeof(float);
    if (ta < 1 || tb < 1 || smem > static_cast<size_t>(kMaxSmem))
      return static_cast<int>(cudaErrorInvalidValue);
    if (tb % 4 == 0)
      return launch_l2<E, 4>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                             cout, ta, tb, mode, smem, st);
    return launch_l2<E, 1>(x, w, bias, gamma, beta, out, b, h, wd, cin, cout,
                           ta, tb, mode, smem, st);
  }
  const TiledPlan plan = tiled_plan(b, h, wd, cin, cout, ta, tb);
  if (!plan.threads) return static_cast<int>(cudaErrorInvalidValue);
  if (cout == 1)
    return launch_tiled_p<E, true>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                                   cout, ta, tb, mode, plan, st);
  return launch_tiled_p<E, false>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                                  cout, ta, tb, mode, plan, st);
}

}  // namespace

// x (b, h, wd, cin) and out (b, 2h, 2wd, cout), float32, or bfloat16 where
// bf16 != 0; w (5, 5, cin, cout), bias (cout,), gamma (cout, cout) and beta
// (cout,) (ignored when mode == 0) float32; all contiguous. mode: 0 none,
// 1 IGDN, 2 GDN. splits == 1: variant 0, the tiled kernel on ta x tb
// tiles, one block per tile and parity plane (tiled_plan); variant 1, the
// kernel that leaves gamma in global memory, one block per tile (a tb that
// is a multiple of 4 runs 4 columns per thread, any other tb one;
// ops/deconv_igdn.py:launch_plan picks it where the tiled kernel's stages
// and gamma do not fit in shared memory); variant 2, bf16 only, the tiled
// kernel on the tensor cores (mma_plan: tb a multiple of 8, Cout above
// 4). splits in {2, 4, 8}: the
// cluster split-K kernel on ta x tb tiles, ta == tb in {1, 2, 4}, cout a
// multiple of 4 up to 128, w, gamma and beta 16-byte aligned.
// Launches on `stream`; returns the launch's CUDA error (0 on success), or
// cudaErrorInvalidValue for a plan it has no kernel or shared memory for.
extern "C" int mmnc_deconv_igdn_forward(const void* x, const float* w,
                                        const float* bias, const float* gamma,
                                        const float* beta, void* out, int b,
                                        int h, int wd, int cin, int cout,
                                        int ta, int tb, int splits, int mode,
                                        int variant, int bf16,
                                        void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_type<__nv_bfloat16>(x, w, bias, gamma, beta, out, b, h, wd,
                                      cin, cout, ta, tb, splits, mode,
                                      variant, st);
  return launch_type<float>(x, w, bias, gamma, beta, out, b, h, wd, cin,
                            cout, ta, tb, splits, mode, variant, st);
}
