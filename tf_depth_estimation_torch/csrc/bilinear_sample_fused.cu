// Fused bilinear warp sampler for Hopper (sm_90a), f32: a forward and a backward kernel.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_warp.py:51 _warp_kernel
// (entry point bilinear_sample_fused, :144, through _sample_fused_fwd_impl, :99, and the
// pallas_call at :114). It samples imgs [B,Hs,Ws,C] at coords [B,Ht,Wt,2] (x, y), both f32
// NHWC, with the reference border rule, per output pixel:
//   x0 = floor(x), x1 = x0 + 1, each clamped to [0, Ws-1] for the gather (y alike)
//   wx0 = (x1 - x) * [x0 unclamped inside], wx1 = (x - x0) * [x1 inside]   (wy alike)
//   out   = w00*im00 + w01*im01 + w10*im10 + w11*im11,  w_ab = wx_a * wy_b
//   wmask = w00 + w01 + w10 + w11
// The JAX entry point takes same-size warps (Ht*Wt == Hs*Ws, any Ht), B % 8 == 0 and
// Hs*Ws <= 131072; the wrapper keeps that rule and sends every other call to
// csrc/bilinear_sample.cu. Both kernels gather with Hs, Ws and write with Ht, Wt.
//
// What sets it apart from bilinear_sample.cu is what stays out of device memory: the
// forward writes out and wmask only, never the four corner planes (4*C floats a pixel)
// that bilinear_sample.cu writes for its plain backward. The backward recomputes the
// four taps from imgs and coords and writes dcoords, the gradient of the function that
// the JAX backward takes (XLA autodiff of the plain sampler, pallas_warp.py:153-156):
//   s_ab  = sum_c dout_c * im_ab_c + dwmask                  (c = 0, 1, ... in order)
//   gwx0  = s00*wy0 + s01*wy1,  gwx1 = s10*wy0 + s11*wy1    (gwy alike, with wx)
//   dx    = gwx1*[x1 inside] - gwx0*[x0 inside]             (dy alike); floor and the
//                                                           clamps have zero gradient
// When the image needs a gradient the same kernel scatters dimgs[tap] += w_ab * dout_c
// with atomicAdd, whose order differs from run to run (as scatter_add_ in the plain
// backward); dcoords has no atomics, so two runs give the same bits. A null dout or
// dwmask reads as zeros. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, never contracted into an FMA), in the reference's order, so the forward
// is bit-equal to the plain PyTorch version on the card; the backward sums the channels
// in order where PyTorch's reduction may take another, within float32 rounding.
//
// The integer tap index is clamped with fminf/fmaxf, which return the other operand for
// a NaN: a NaN or infinite coordinate (a disparity that underflows to 0) gathers inside
// the image, and its NaN weights carry the NaN to out, as in the plain version.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32), a config-3 step's 4 calls (B=16,
// C=3, 192x256 down to 24x32; 1,044,480 target pixels): the forward must read imgs (12 B
// a pixel) and coords (8) and write out (12) and wmask (4), 37.6 MB, 11.2 us; its ~40
// operations a pixel take 0.6 us. The backward of dcoords reads imgs, coords and dout and
// writes dcoords, 40 B a pixel, 41.8 MB, 12.5 us; ~63 operations a pixel, 1.0 us. Bytes
// bound both. The design: one thread per output pixel, adjacent threads on adjacent
// pixels, so the coords, dout, out, wmask and dcoords accesses coalesce; the taps are
// gathered straight from global memory through L1, where a real warp's neighbouring
// pixels find the lines their neighbours loaded. None of the TPU kernel's layout (8
// images as sublanes, a channel-major grid, a VMEM row limit) is needed here.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// The prologue shared by both kernels: weights, inside flags and clamped tap offsets.
struct Taps {
  float wx0, wx1, wy0, wy1;   // weights, zero where the unclamped tap is outside
  float inx0, inx1, iny0, iny1;  // 1 where the unclamped tap is inside, else 0
  long long o00, o01, o10, o11;  // element offsets of the taps in the image, channel 0
};

__device__ __forceinline__ Taps taps(float cx, float cy, int Hs, int Ws, int C) {
  Taps t;
  const float x0 = floorf(cx), y0 = floorf(cy);
  const float x1 = __fadd_rn(x0, 1.f), y1 = __fadd_rn(y0, 1.f);
  const float xmax = (float)(Ws - 1), ymax = (float)(Hs - 1);
  const float x0s = fminf(fmaxf(x0, 0.f), xmax), x1s = fminf(fmaxf(x1, 0.f), xmax);
  const float y0s = fminf(fmaxf(y0, 0.f), ymax), y1s = fminf(fmaxf(y1, 0.f), ymax);
  t.inx0 = x0 == x0s ? 1.f : 0.f;
  t.inx1 = x1 == x1s ? 1.f : 0.f;
  t.iny0 = y0 == y0s ? 1.f : 0.f;
  t.iny1 = y1 == y1s ? 1.f : 0.f;
  t.wx0 = __fmul_rn(__fsub_rn(x1, cx), t.inx0);
  t.wx1 = __fmul_rn(__fsub_rn(cx, x0), t.inx1);
  t.wy0 = __fmul_rn(__fsub_rn(y1, cy), t.iny0);
  t.wy1 = __fmul_rn(__fsub_rn(cy, y0), t.iny1);
  const long long ix0 = (int)x0s, ix1 = (int)x1s, iy0 = (int)y0s, iy1 = (int)y1s;
  t.o00 = (iy0 * Ws + ix0) * C;
  t.o01 = (iy1 * Ws + ix0) * C;
  t.o10 = (iy0 * Ws + ix1) * C;
  t.o11 = (iy1 * Ws + ix1) * C;
  return t;
}

__global__ void __launch_bounds__(THREADS)
warp_fused_forward_kernel(const float* __restrict__ imgs,
                          const float* __restrict__ coords, float* __restrict__ out,
                          float* __restrict__ wmask, int Hs, int Ws, int Ht, int Wt, int C,
                          long long n) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;  // output pixel
  if (p >= n) return;
  const long long b = p / ((long long)Ht * Wt);
  const Taps t = taps(coords[2 * p], coords[2 * p + 1], Hs, Ws, C);
  const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
  const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
  wmask[p] = __fadd_rn(__fadd_rn(__fadd_rn(w00, w01), w10), w11);
  const float* img = imgs + b * Hs * Ws * C;
  for (int c = 0; c < C; ++c) {
    float acc = __fmul_rn(w00, __ldg(img + t.o00 + c));
    acc = __fadd_rn(acc, __fmul_rn(w01, __ldg(img + t.o01 + c)));
    acc = __fadd_rn(acc, __fmul_rn(w10, __ldg(img + t.o10 + c)));
    acc = __fadd_rn(acc, __fmul_rn(w11, __ldg(img + t.o11 + c)));
    out[p * C + c] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
warp_fused_backward_kernel(const float* __restrict__ imgs,
                           const float* __restrict__ coords, const float* __restrict__ dout,
                           const float* __restrict__ dwmask, float* __restrict__ dcoords,
                           float* __restrict__ dimgs, int Hs, int Ws, int Ht, int Wt, int C,
                           long long n) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;  // output pixel
  if (p >= n) return;
  const long long b = p / ((long long)Ht * Wt);
  const Taps t = taps(coords[2 * p], coords[2 * p + 1], Hs, Ws, C);
  if (dcoords != nullptr) {
    const float* img = imgs + b * Hs * Ws * C;
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int c = 0; c < C; ++c) {
      const float d = dout != nullptr ? dout[p * C + c] : 0.f;
      const float a00 = __fmul_rn(d, __ldg(img + t.o00 + c));
      const float a01 = __fmul_rn(d, __ldg(img + t.o01 + c));
      const float a10 = __fmul_rn(d, __ldg(img + t.o10 + c));
      const float a11 = __fmul_rn(d, __ldg(img + t.o11 + c));
      s00 = c == 0 ? a00 : __fadd_rn(s00, a00);
      s01 = c == 0 ? a01 : __fadd_rn(s01, a01);
      s10 = c == 0 ? a10 : __fadd_rn(s10, a10);
      s11 = c == 0 ? a11 : __fadd_rn(s11, a11);
    }
    if (dwmask != nullptr) {
      const float dm = dwmask[p];
      s00 = __fadd_rn(s00, dm);
      s01 = __fadd_rn(s01, dm);
      s10 = __fadd_rn(s10, dm);
      s11 = __fadd_rn(s11, dm);
    }
    const float gwx0 = __fadd_rn(__fmul_rn(s00, t.wy0), __fmul_rn(s01, t.wy1));
    const float gwx1 = __fadd_rn(__fmul_rn(s10, t.wy0), __fmul_rn(s11, t.wy1));
    const float gwy0 = __fadd_rn(__fmul_rn(s00, t.wx0), __fmul_rn(s10, t.wx1));
    const float gwy1 = __fadd_rn(__fmul_rn(s01, t.wx0), __fmul_rn(s11, t.wx1));
    dcoords[2 * p] = __fsub_rn(__fmul_rn(gwx1, t.inx1), __fmul_rn(gwx0, t.inx0));
    dcoords[2 * p + 1] = __fsub_rn(__fmul_rn(gwy1, t.iny1), __fmul_rn(gwy0, t.iny0));
  }
  if (dimgs != nullptr) {
    float* dimg = dimgs + b * Hs * Ws * C;
    const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
    const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
    for (int c = 0; c < C; ++c) {
      const float d = dout != nullptr ? dout[p * C + c] : 0.f;
      atomicAdd(dimg + t.o00 + c, __fmul_rn(w00, d));
      atomicAdd(dimg + t.o01 + c, __fmul_rn(w01, d));
      atomicAdd(dimg + t.o10 + c, __fmul_rn(w10, d));
      atomicAdd(dimg + t.o11 + c, __fmul_rn(w11, d));
    }
  }
}

unsigned blocks(long long n) { return (unsigned)((n + THREADS - 1) / THREADS); }

}  // namespace

// imgs [B,Hs,Ws,C], coords [B,Ht,Wt,2], out [B,Ht,Wt,C], wmask [B,Ht,Wt]; all f32,
// contiguous, on the current device; Hs, Ws >= 1. Launches on `stream` and returns the
// cudaError_t of the launch.
extern "C" int bilinear_sample_fused_forward_launch(const void* imgs, const void* coords,
                                                    void* out, void* wmask, int B, int Hs,
                                                    int Ws, int Ht, int Wt, int C,
                                                    void* stream) {
  const long long n = (long long)B * Ht * Wt;
  if (n == 0) return 0;
  warp_fused_forward_kernel<<<blocks(n), THREADS, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(coords),
      static_cast<float*>(out), static_cast<float*>(wmask), Hs, Ws, Ht, Wt, C, n);
  return static_cast<int>(cudaGetLastError());
}

// dout [B,Ht,Wt,C] or null, dwmask [B,Ht,Wt] or null (null reads as zeros); dcoords
// [B,Ht,Wt,2] or null (not computed); dimgs [B,Hs,Ws,C] zero-filled by the caller, or null
// (not computed). The rest as for the forward.
extern "C" int bilinear_sample_fused_backward_launch(const void* imgs, const void* coords,
                                                     const void* dout, const void* dwmask,
                                                     void* dcoords, void* dimgs, int B,
                                                     int Hs, int Ws, int Ht, int Wt, int C,
                                                     void* stream) {
  const long long n = (long long)B * Ht * Wt;
  if (n == 0 || (dcoords == nullptr && dimgs == nullptr)) return 0;
  warp_fused_backward_kernel<<<blocks(n), THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(imgs), static_cast<const float*>(coords),
      static_cast<const float*>(dout), static_cast<const float*>(dwmask),
      static_cast<float*>(dcoords), static_cast<float*>(dimgs), Hs, Ws, Ht, Wt, C, n);
  return static_cast<int>(cudaGetLastError());
}
