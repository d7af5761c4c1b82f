// Transposed conv k5/s2 (padding 2, output_padding 1) + optional (I)GDN,
// NHWC float32, writing the interleaved (B, 2H, 2W, Cout) output directly.
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
// program in VMEM and could not fit 64x64 and 128x128 inputs; here a block
// owns a tile of TA x TB input positions, i.e. 2TA x 2TB output pixels
// times all Cout channels (the IGDN epilogue mixes every channel of a
// pixel). It stages its input tile with a 1-pixel halo in shared memory,
// streams the weight from L2 (1 MB at 100x100: read once per tap and input
// channel and reused for kCols output pixels from a register), accumulates
// the pre-activation in registers, parks it in shared memory, applies the
// (I)GDN epilogue with gamma in shared memory and writes each output pixel
// once, already interleaved: no depth-to-space pass. Taps that fall wholly
// on the zero padding are skipped, so the 1x1 and 2x2 latent stages do only
// the products they need. Plain FMAs, no tensor cores: a first, simple
// kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// kCols: input columns (same parity) per thread, 4 or, for tiles narrower
// than 4, 1.
template <int kCols>
__global__ void __launch_bounds__(kThreads)
deconv_igdn_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ out,
                   int h, int wd, int cin, int cout, int ta, int tb,
                   int mode) {
  extern __shared__ float smem[];
  const int hx = ta + 2, wx = tb + 2;
  const int pix = 4 * ta * tb;            // output pixels of the tile
  float* x_s = smem;                      // hx*wx*cin, input tile + halo
  float* y_s = x_s + hx * wx * cin;       // pix*cout, output-pixel order
  float* g_t = y_s + pix * cout;          // cout*cout, g_t[j*cout+o]
  float* b_s = g_t + (mode ? cout * cout : 0);  // cout

  const int n = blockIdx.z;
  const int a0 = blockIdx.y * ta, b0 = blockIdx.x * tb;

  for (int i = threadIdx.x; i < hx * wx * cin; i += blockDim.x) {
    const int ci = i % cin;
    const int p = i / cin;
    const int ia = a0 - 1 + p / wx, ib = b0 - 1 + p % wx;
    x_s[i] = (ia >= 0 && ia < h && ib >= 0 && ib < wd)
                 ? x[((static_cast<long long>(n) * h + ia) * wd + ib) * cin + ci]
                 : 0.f;
  }
  if (mode) {
    for (int i = threadIdx.x; i < cout * cout; i += blockDim.x) {
      const int o = i / cout;
      const int j = i - o * cout;
      g_t[j * cout + o] = gamma[i];
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
    for (int k = 0; k < kCols; ++k) acc[k] = bv;
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
      y_s[(orow * 2 * tb + ocol) * cout + co] = acc[k];
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
      for (int j = 0; j < cout; ++j) {
        const float yj = yp[j];
        norm = fmaf(g_t[j * cout + o], yj * yj, norm);
      }
      v = (mode == 1) ? v * sqrtf(norm) : v * rsqrtf(norm);
    }
    out[((static_cast<long long>(n) * oh + gy) * ow + gx) * cout + o] = v;
  }
}

}  // namespace

// x (b, h, wd, cin), w (5, 5, cin, cout), bias (cout,), gamma (cout, cout)
// and beta (cout,) (ignored when mode == 0), out (b, 2h, 2wd, cout); all
// contiguous float32. mode: 0 none, 1 IGDN, 2 GDN. A tb that is a
// multiple of 4 runs 4 columns per thread, any other tb one. Launches on
// `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mmnc_deconv_igdn_forward(const float* x, const float* w,
                                        const float* bias, const float* gamma,
                                        const float* beta, float* out, int b,
                                        int h, int wd, int cin, int cout,
                                        int ta, int tb, int mode,
                                        void* stream) {
  if (b <= 0 || h <= 0 || wd <= 0) return 0;
  const size_t floats = static_cast<size_t>((ta + 2) * (tb + 2) * cin) +
                        static_cast<size_t>(4 * ta * tb * cout) +
                        (mode ? static_cast<size_t>(cout * cout + cout) : 0);
  const size_t smem = floats * sizeof(float);
  const dim3 grid((wd + tb - 1) / tb, (h + ta - 1) / ta, b);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (tb % 4 == 0) {
    err = cudaFuncSetAttribute(deconv_igdn_kernel<4>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    deconv_igdn_kernel<4><<<grid, kThreads, smem, st>>>(
        x, w, bias, gamma, beta, out, h, wd, cin, cout, ta, tb, mode);
  } else {
    err = cudaFuncSetAttribute(deconv_igdn_kernel<1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    deconv_igdn_kernel<1><<<grid, kThreads, smem, st>>>(
        x, w, bias, gamma, beta, out, h, wd, cin, cout, ta, tb, mode);
  }
  return static_cast<int>(cudaGetLastError());
}
