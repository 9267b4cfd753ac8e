// Bilinear sampling with the reference border rule, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_sample.py:97 _sample_kernel
// (entry point bilinear_sample_tpu, :255) together with the XLA prologue that fed it
// (_prologue, :69). Given imgs [B,Hs,Ws,C] and coords [B,Ht,Wt,2] (x, y), both f32 NHWC,
// it writes, per output pixel,
//   x0 = floor(x), x1 = x0 + 1, each clamped to [0, Ws-1] for the gather (y alike)
//   wx0 = (x1 - x) * [x0 unclamped inside], wx1 = (x - x0) * [x1 inside]   (wy alike)
//   out   = w00*im00 + w01*im01 + w10*im10 + w11*im11,  w_ab = wx_a * wy_b
//   wmask = w00 + w01 + w10 + w11
// and, when `corners` is not null, the four gathered corner planes im00, im01, im10, im11
// ([4][B,Ht,Wt,C]) that the backward's coordinate gradient needs. Every product and sum
// is rounded on its own, in the reference's order (__fmul_rn / __fadd_rn are never
// contracted into FMAs), so the kernel computes what the plain PyTorch version computes.
//
// Bound on an H100 SXM, config 4's largest call (B=10, 224x480, C=3): it must read imgs
// (12.9 MB) and coords (8.6 MB) and write out (12.9 MB) and wmask (4.3 MB), 38.7 MB, which
// take 11.6 us at 3.35 TB/s; its ~30 floating-point operations per pixel take 0.5 us at
// the 67 TFLOP/s f32 rate. Bytes bound it. The design: one thread per output pixel,
// adjacent threads on adjacent pixels, so the coords, out and wmask accesses coalesce;
// the four taps are gathered straight from global memory through L1/L2. For a real warp
// neighbouring pixels sample neighbouring source pixels, so most taps hit lines already
// in L1. None of the TPU kernel's workarounds (the row-band DMA, 128-lane gathers, width
// padding, the coverage flag and its fallback) is needed here.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
bilinear_sample_kernel(const float* __restrict__ imgs, const float* __restrict__ coords,
                       float* __restrict__ out, float* __restrict__ wmask,
                       float* __restrict__ corners, int Hs, int Ws, int Ht, int Wt, int C,
                       long long n) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;  // output pixel
  if (p >= n) return;
  const long long b = p / ((long long)Ht * Wt);
  const float cx = coords[2 * p], cy = coords[2 * p + 1];
  const float x0 = floorf(cx), y0 = floorf(cy);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float xmax = (float)(Ws - 1), ymax = (float)(Hs - 1);
  const float x0s = fminf(fmaxf(x0, 0.f), xmax), x1s = fminf(fmaxf(x1, 0.f), xmax);
  const float y0s = fminf(fmaxf(y0, 0.f), ymax), y1s = fminf(fmaxf(y1, 0.f), ymax);
  const float wx0 = __fmul_rn(__fsub_rn(x1, cx), x0 == x0s ? 1.f : 0.f);
  const float wx1 = __fmul_rn(__fsub_rn(cx, x0), x1 == x1s ? 1.f : 0.f);
  const float wy0 = __fmul_rn(__fsub_rn(y1, cy), y0 == y0s ? 1.f : 0.f);
  const float wy1 = __fmul_rn(__fsub_rn(cy, y0), y1 == y1s ? 1.f : 0.f);
  const float w00 = __fmul_rn(wx0, wy0), w01 = __fmul_rn(wx0, wy1);
  const float w10 = __fmul_rn(wx1, wy0), w11 = __fmul_rn(wx1, wy1);
  wmask[p] = __fadd_rn(__fadd_rn(__fadd_rn(w00, w01), w10), w11);

  const float* img = imgs + b * Hs * Ws * C;
  const int ix0 = (int)x0s, ix1 = (int)x1s, iy0 = (int)y0s, iy1 = (int)y1s;
  const float* t00 = img + ((long long)iy0 * Ws + ix0) * C;
  const float* t01 = img + ((long long)iy1 * Ws + ix0) * C;
  const float* t10 = img + ((long long)iy0 * Ws + ix1) * C;
  const float* t11 = img + ((long long)iy1 * Ws + ix1) * C;
  const long long plane = n * C;
  for (int c = 0; c < C; ++c) {
    const float im00 = __ldg(t00 + c), im01 = __ldg(t01 + c);
    const float im10 = __ldg(t10 + c), im11 = __ldg(t11 + c);
    float acc = __fmul_rn(w00, im00);
    acc = __fadd_rn(acc, __fmul_rn(w01, im01));
    acc = __fadd_rn(acc, __fmul_rn(w10, im10));
    acc = __fadd_rn(acc, __fmul_rn(w11, im11));
    out[p * C + c] = acc;
    if (corners != nullptr) {
      corners[p * C + c] = im00;
      corners[plane + p * C + c] = im01;
      corners[2 * plane + p * C + c] = im10;
      corners[3 * plane + p * C + c] = im11;
    }
  }
}

}  // namespace

// imgs [B,Hs,Ws,C], coords [B,Ht,Wt,2], out [B,Ht,Wt,C], wmask [B,Ht,Wt], corners null or
// [4,B,Ht,Wt,C]; all f32, contiguous, on the current device; Hs, Ws >= 1. Launches on
// `stream` and returns the cudaError_t of the launch.
extern "C" int bilinear_sample_launch(const void* imgs, const void* coords, void* out,
                                      void* wmask, void* corners, int B, int Hs, int Ws,
                                      int Ht, int Wt, int C, void* stream) {
  const long long n = (long long)B * Ht * Wt;
  if (n == 0) return 0;
  const long long blocks = (n + THREADS - 1) / THREADS;
  bilinear_sample_kernel<<<(unsigned)blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(coords),
      static_cast<float*>(out), static_cast<float*>(wmask), static_cast<float*>(corners),
      Hs, Ws, Ht, Wt, C, n);
  return static_cast<int>(cudaGetLastError());
}
