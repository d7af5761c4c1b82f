// (I)GDN over the rows of a channel-minor (N, C) float32 matrix.
//
// Replaces mmnc_tpu/ops/gdn_pallas.py:_gdn_forward (kernel body
// _gdn_kernel): out[r, o] = x[r, o] * rsqrt(beta[o] + sum_j gamma[o, j] *
// x[r, j]^2) for GDN, * sqrt(...) for IGDN. gamma is (C, C) in [out, in]
// layout.
//
// Bound on the H100: each row of C floats is read once and written once
// (8*C bytes) against C*C FMAs, i.e. C/4 FLOP per byte. The CUDA cores'
// f32 rate (67 TFLOP/s) and HBM (3.35 TB/s) balance at 20 FLOP per byte,
// so C = 50 is bound by bytes and C = 100 by f32 FMAs, both close to the
// balance point. The design keeps everything between the one read and
// the one write on chip: a persistent block (as many as fit on the SMs)
// stages gamma and beta in shared memory once, then walks over tiles of
// rows, staging each tile and its squares, and each thread
// accumulates one output channel for kRowsPerThread rows. Rows and gamma
// are kept with a padded stride `cp` (a multiple of 4, zero-filled past C)
// so the inner loop reads 4 channels per 16-byte shared-memory load: per 4
// input channels a thread issues one load of gamma[o, j..j+3] and one load
// of x^2[r, j..j+3] per row (the same address across the warp: a
// broadcast) for 4*kRowsPerThread FMAs. cp/4 is kept odd so the gamma rows
// of 8 neighbouring output channels fall in distinct banks. Plain FMAs, no
// tensor cores: a first, simple kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerThread = 4;

__global__ void __launch_bounds__(kThreads)
gdn_kernel(const float* __restrict__ x, const float* __restrict__ gamma,
           const float* __restrict__ beta, float* __restrict__ out,
           int n, int c, int cp, int tile_rows, int inverse) {
  extern __shared__ float4 smem4[];
  float* g_s = reinterpret_cast<float*>(smem4);  // c*cp: g_s[o*cp + j]
  float* x_s = g_s + c * cp;                     // tile_rows*cp
  float* x2_s = x_s + tile_rows * cp;            // tile_rows*cp, squares
  float* b_s = x2_s + tile_rows * cp;            // c

  for (int i = threadIdx.x; i < c * cp; i += blockDim.x) {
    const int o = i / cp;
    const int j = i - o * cp;
    g_s[i] = (j < c) ? gamma[o * c + j] : 0.f;
  }
  for (int i = threadIdx.x; i < c; i += blockDim.x) b_s[i] = beta[i];

  // persistent blocks: gamma is staged once per block, not once per tile
  const int n_tiles = (n + tile_rows - 1) / tile_rows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * tile_rows;
    const int rows = min(tile_rows, n - row0);
    const long long base = static_cast<long long>(row0) * c;
    __syncthreads();  // the previous tile's rows are no longer read
    // a tile is one contiguous run of rows*c floats: coalesced loads
    for (int i = threadIdx.x; i < tile_rows * cp; i += blockDim.x) {
      const int r = i / cp;
      const int j = i - r * cp;
      const float v = (r < rows && j < c) ? x[base + r * c + j] : 0.f;
      x_s[i] = v;
      x2_s[i] = v * v;
    }
    __syncthreads();

    const int groups = tile_rows / kRowsPerThread;
    for (int item = threadIdx.x; item < groups * c; item += blockDim.x) {
      const int o = item % c;
      const int r0 = (item / c) * kRowsPerThread;
      float acc[kRowsPerThread];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) acc[r] = b_s[o];
      const float4* g4 = reinterpret_cast<const float4*>(g_s + o * cp);
      const float4* x4 = reinterpret_cast<const float4*>(x2_s + r0 * cp);
      const int steps = cp / 4;
      for (int j = 0; j < steps; ++j) {
        const float4 g = g4[j];
#pragma unroll
        for (int r = 0; r < kRowsPerThread; ++r) {
          const float4 v = x4[r * steps + j];
          acc[r] = fmaf(g.x, v.x, acc[r]);
          acc[r] = fmaf(g.y, v.y, acc[r]);
          acc[r] = fmaf(g.z, v.z, acc[r]);
          acc[r] = fmaf(g.w, v.w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int row = r0 + r;
        if (row < rows) {
          const float xv = x_s[row * cp + o];
          out[base + row * c + o] =
              inverse ? xv * sqrtf(acc[r]) : xv * rsqrtf(acc[r]);
        }
      }
    }
  }
}

int padded_stride(int c) {
  int cp = (c + 3) / 4 * 4;
  if ((cp / 4) % 2 == 0) cp += 4;
  return cp;
}

}  // namespace

// x, out: (n, c) row-major float32; gamma (c, c); beta (c,). tile_rows is
// a multiple of kRowsPerThread. Launches on `stream`; returns the
// cudaGetLastError() of the launch (0 on success).
extern "C" int mmnc_gdn_forward(const float* x, const float* gamma,
                                const float* beta, float* out, int n, int c,
                                int tile_rows, int inverse, void* stream) {
  if (n <= 0) return 0;
  const int cp = padded_stride(c);
  const size_t smem =
      static_cast<size_t>(c * cp + 2 * tile_rows * cp + c) * sizeof(float);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      gdn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gdn_kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n + tile_rows - 1) / tile_rows;
  const int resident = sms * per_sm > 0 ? sms * per_sm : 1;
  const int blocks = tiles < resident ? tiles : resident;
  gdn_kernel<<<blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      x, gamma, beta, out, n, c, cp, tile_rows, inverse);
  return static_cast<int>(cudaGetLastError());
}
