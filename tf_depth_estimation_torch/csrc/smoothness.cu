// Second-order smoothness of a depth or flow map, forward and backward, for Hopper
// (sm_90a), f32.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_losses.py:140 _smooth_kernel
// (entry point smoothness_fused, :182) and the XLA autodiff that was its backward (:191).
// For a map x [B,H,W] (a C=1 plane, read through its batch, row and column strides) it
// computes, with dx = x[i,j+1]-x[i,j] and dy = x[i+1,j]-x[i,j],
//   loss = 1/B sum_b ( sum|dx[i,j+1]-dx[i,j]| / (H(W-2)) + sum|dy[i+1,j]-dy[i,j]| / ((H-2)W)
//                    + sum|dx[i+1,j]-dx[i,j]| / ((H-1)(W-1))
//                    + sum|dy[i,j+1]-dy[i,j]| / ((H-1)(W-1)) )
// Every difference is formed in the plain version's operand order, so each term has the
// plain version's bits and its sign, which decides the gradient, too: the two mixed terms
// are equal in exact arithmetic but not always in float.
//
// Forward: one thread per pixel adds the four terms that start at its pixel into block
// partials [B, blocks, 4]; a one-block kernel sums them in a fixed order (no float
// atomics), so repeated runs give the same bits. Backward, in gather form: one thread per
// pixel recomputes the terms that read its pixel and adds ct * sgn(term) / (B * count)
// with weights (1, -2, 1) for dxx and dyy and (1, -1, -1, 1) for the mixed terms;
// sgn(0) = 0, as the derivative of |.| in PyTorch and JAX.
//
// Bound on an H100 SXM, config 2's largest call (B=10, 240x720): the forward must read
// the map once (6.9 MB, 2.1 us at 3.35 TB/s), the backward read it and write the gradient
// (13.8 MB, 4.1 us); ~25 operations a pixel take 0.06 us at 67 TFLOP/s. Bytes bound both.
// Neighbouring threads take neighbouring pixels of a row, so loads coalesce and the
// neighbours' re-reads hit L1; at these sizes the host's launch cost is larger than the
// work, which is why the forward is two launches and the backward one, where the plain
// version takes ~17 kernels each way.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FIN_THREADS = 128;  // 4 warps, one per term

struct Plane {
  const float* x;
  long long sb, sh, sw;  // strides in elements
  int H, W;
  __device__ __forceinline__ float at(int b, int i, int j) const {
    return __ldg(x + b * sb + i * sh + j * sw);
  }
};

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// The four terms at a position, each as the plain version forms it.
__device__ __forceinline__ float term_xx(const Plane& p, int b, int i, int j) {
  const float dx0 = __fsub_rn(p.at(b, i, j + 1), p.at(b, i, j));
  const float dx1 = __fsub_rn(p.at(b, i, j + 2), p.at(b, i, j + 1));
  return __fsub_rn(dx1, dx0);
}
__device__ __forceinline__ float term_yy(const Plane& p, int b, int i, int j) {
  const float dy0 = __fsub_rn(p.at(b, i + 1, j), p.at(b, i, j));
  const float dy1 = __fsub_rn(p.at(b, i + 2, j), p.at(b, i + 1, j));
  return __fsub_rn(dy1, dy0);
}
__device__ __forceinline__ float term_xy(const Plane& p, int b, int i, int j) {  // dx[i+1]-dx[i]
  const float dx0 = __fsub_rn(p.at(b, i, j + 1), p.at(b, i, j));
  const float dx1 = __fsub_rn(p.at(b, i + 1, j + 1), p.at(b, i + 1, j));
  return __fsub_rn(dx1, dx0);
}
__device__ __forceinline__ float term_yx(const Plane& p, int b, int i, int j) {  // dy[j+1]-dy[j]
  const float dy0 = __fsub_rn(p.at(b, i + 1, j), p.at(b, i, j));
  const float dy1 = __fsub_rn(p.at(b, i + 1, j + 1), p.at(b, i, j + 1));
  return __fsub_rn(dy1, dy0);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (blocks, B): partials[b, blockIdx.x, t] = the block's sum of |term t|.
__global__ void __launch_bounds__(THREADS)
smooth_partials_kernel(Plane p, float* __restrict__ partials) {
  const int b = blockIdx.y;
  const long long px = (long long)blockIdx.x * THREADS + threadIdx.x;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  if (px < (long long)p.H * p.W) {
    const int i = (int)(px / p.W), j = (int)(px % p.W);
    if (j + 2 < p.W) s[0] = fabsf(term_xx(p, b, i, j));
    if (i + 2 < p.H) s[1] = fabsf(term_yy(p, b, i, j));
    if (i + 1 < p.H && j + 1 < p.W) {
      s[2] = fabsf(term_xy(p, b, i, j));
      s[3] = fabsf(term_yx(p, b, i, j));
    }
  }
  __shared__ float red[THREADS / 32][4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float v = warp_sum(s[t]);
    if (lane == 0) red[warp][t] = v;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    float acc = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) acc += red[w][threadIdx.x];
    partials[((long long)b * gridDim.x + blockIdx.x) * 4 + threadIdx.x] = acc;
  }
}

// One block: warp t sums term t's partials image by image, each image's sum over its
// count; out = (sum over images and terms) / B, in double, in a fixed order.
__global__ void __launch_bounds__(FIN_THREADS)
smooth_finish_kernel(const float* __restrict__ partials, int blocks, int B, int H, int W,
                     float* __restrict__ out) {
  const int t = threadIdx.x / 32, lane = threadIdx.x % 32;
  const double count[4] = {(double)H * (W - 2), (double)(H - 2) * W,
                           (double)(H - 1) * (W - 1), (double)(H - 1) * (W - 1)};
  double total = 0.0;
  for (int b = 0; b < B; ++b) {
    double v = 0.0;
    for (int k = lane; k < blocks; k += 32) v += partials[((long long)b * blocks + k) * 4 + t];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    total += v / count[t];
  }
  __shared__ double per_term[4];
  if (lane == 0) per_term[t] = total;
  __syncthreads();
  if (threadIdx.x == 0)
    *out = (float)((per_term[0] + per_term[1] + per_term[2] + per_term[3]) / B);
}

// grid (ceil(H*W / THREADS), B): dx[b,i,j] (contiguous [B,H,W]) for one pixel a thread.
__global__ void __launch_bounds__(THREADS)
smooth_backward_kernel(Plane p, const float* __restrict__ ct, int B,
                       float* __restrict__ dx) {
  const int b = blockIdx.y;
  const long long px = (long long)blockIdx.x * THREADS + threadIdx.x;
  const int H = p.H, W = p.W;
  if (px >= (long long)H * W) return;
  const int i = (int)(px / W), j = (int)(px % W);
  const float c = *ct;
  // d mean / d term = 1 / (B * count), each count converted to float once
  const float g_xx = c / (float)((long long)B * H * (W - 2));
  const float g_yy = c / (float)((long long)B * (H - 2) * W);
  const float g_m = c / (float)((long long)B * (H - 1) * (W - 1));
  // dxx at (i, j - k) reads this pixel with weight (1, -2, 1)[k]; dyy alike along i
  float a_xx = 0.f, a_yy = 0.f, a_xy = 0.f, a_yx = 0.f;
  if (j <= W - 3) a_xx += sgn(term_xx(p, b, i, j));
  if (j >= 1 && j - 1 <= W - 3) a_xx -= 2.f * sgn(term_xx(p, b, i, j - 1));
  if (j >= 2) a_xx += sgn(term_xx(p, b, i, j - 2));
  if (i <= H - 3) a_yy += sgn(term_yy(p, b, i, j));
  if (i >= 1 && i - 1 <= H - 3) a_yy -= 2.f * sgn(term_yy(p, b, i - 1, j));
  if (i >= 2) a_yy += sgn(term_yy(p, b, i - 2, j));
  // a mixed term at (i', j') reads (i', j') +1, (i', j'+1) -1, (i'+1, j') -1, (i'+1, j'+1) +1
  const bool r0 = i <= H - 2, r1 = i >= 1, c0 = j <= W - 2, c1 = j >= 1;
  if (r0 && c0) { a_xy += sgn(term_xy(p, b, i, j));         a_yx += sgn(term_yx(p, b, i, j)); }
  if (r0 && c1) { a_xy -= sgn(term_xy(p, b, i, j - 1));     a_yx -= sgn(term_yx(p, b, i, j - 1)); }
  if (r1 && c0) { a_xy -= sgn(term_xy(p, b, i - 1, j));     a_yx -= sgn(term_yx(p, b, i - 1, j)); }
  if (r1 && c1) { a_xy += sgn(term_xy(p, b, i - 1, j - 1)); a_yx += sgn(term_yx(p, b, i - 1, j - 1)); }
  // the a_* are small integers, exact; one rounding per product, then a fixed sum order
  float g = __fmul_rn(a_xx, g_xx);
  g = __fadd_rn(g, __fmul_rn(a_yy, g_yy));
  g = __fadd_rn(g, __fmul_rn(a_xy, g_m));
  g = __fadd_rn(g, __fmul_rn(a_yx, g_m));
  dx[(long long)b * H * W + px] = g;
}

Plane make_plane(const void* x, int H, int W, long long sb, long long sh, long long sw) {
  return Plane{static_cast<const float*>(x), sb, sh, sw, H, W};
}

}  // namespace

extern "C" {

// Blocks of the forward's first kernel for an H x W map: the partials buffer holds
// B * blocks * 4 floats.
int smoothness_blocks(int H, int W) {
  return (int)(((long long)H * W + THREADS - 1) / THREADS);
}

// x: a [B,H,W] f32 plane with element strides (sb, sh, sw); H, W >= 3; partials: B *
// smoothness_blocks(H, W) * 4 floats of scratch; out: one float. Launches both kernels on
// `stream` and returns the cudaError_t of the launches.
int smoothness_forward_launch(const void* x, int B, int H, int W, long long sb,
                              long long sh, long long sw, void* partials, void* out,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = smoothness_blocks(H, W);
  smooth_partials_kernel<<<dim3(blocks, B), THREADS, 0, s>>>(
      make_plane(x, H, W, sb, sh, sw), static_cast<float*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  smooth_finish_kernel<<<1, FIN_THREADS, 0, s>>>(static_cast<const float*>(partials),
                                                 blocks, B, H, W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// x as above; ct: the loss's cotangent, one float on the device; dx: a contiguous
// [B,H,W] f32 output. Launches on `stream`, returns the cudaError_t of the launch.
int smoothness_backward_launch(const void* x, int B, int H, int W, long long sb,
                               long long sh, long long sw, const void* ct, void* dx,
                               void* stream) {
  smooth_backward_kernel<<<dim3(smoothness_blocks(H, W), B), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      make_plane(x, H, W, sb, sh, sw), static_cast<const float*>(ct), B,
      static_cast<float*>(dx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
