// Scale-invariant-gradient L2 loss, forward and backward, for Hopper (sm_90a), f32.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_losses.py:63 _sig_kernel
// (entry point sig_l2_fused, :116, launched from _sig_fused_impl, :81-97) and the XLA
// autodiff that was its backward (_sig_bwd, :126-131). For pred and gt [B,H,W] (C=1
// planes, each read through its batch, row and column strides) and deltas d_1..d_K:
//   per map f and term t = (d, axis): gf(i) = (f(i+d) - f(i)) / ((|f(i+d)| + |f(i)|) + eps_sig),
//     defined where i+d lies inside the image along the axis (else the term is 0);
//   acc(i) = sum over the terms, x before y for each delta, of (gp(i) - gg(i))^2;
//   loss   = sum_i sqrt(acc(i) + eps_l2) / (B H W).
// Every product, sum and quotient is rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn,
// __fsqrt_rn: no contraction into FMAs), in the order of the plain version
// (ops/sig.py:sig_l2_plain) and of the gather formula (ops/sig_l2.py).
//
// Forward: one thread per pixel computes acc(i) and s(i) = sqrt(acc(i) + eps_l2), saves
// s(i) for the backward (one float a pixel) and adds s into block partials [B, blocks]; a
// one-block kernel sums the partials in double in a fixed order (no float atomics), so
// repeated runs give the same bits.
// Backward, in gather form, one thread per pixel j, no atomics: for every delta and axis
// the term whose origin is j (if j+d is inside) and the term whose end is j (if j-d is
// inside) each add, with q = (ct / (B H W)) / s(origin) and w = (gp - gg) q,
//   to dpred: origin -(w (1 + gp sgn(f(j)))) / vp,   end (w (1 - gp sgn(f(j)))) / vp,
//   to dgt:   origin  (w (1 + gg sgn(g(j)))) / vg,   end -(w (1 - gg sgn(g(j)))) / vg,
// where vp, vg are the terms' denominators; sgn(0) = 0, the derivative of |.| in PyTorch.
//
// Bound on an H100 SXM, the 5-delta call at 192x256, B=8 (393,216 pixels, ~3.8 M terms):
// the forward must read pred and gt once (3.1 MB, 0.94 us at 3.35 TB/s) for ~15 float32
// operations a term (0.87 us at 67 TFLOP/s), so bytes bound it; the backward must read
// them and write d pred (4.7 MB, 1.41 us) for ~24 operations a term (1.38 us), so bytes
// bound it too: 2.35 us for the pair (chip_smoke.py:sig_bound). Reading the saved s and
// computing each term at both of its ends are this design's own costs, above that
// bound. Neighbouring threads take
// neighbouring pixels of a row, so loads coalesce and the re-reads of the shifted
// neighbours hit L1/L2. At the training path's sizes (B=1, at most 49,152 pixels a call)
// the host's launch cost is far larger than the work, which is why the forward is two
// launches and the backward one, where the plain composition takes ~15-25 kernels each way.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int FIN_THREADS = 256;
constexpr int MAX_DELTAS = 8;

struct Deltas {
  int n;
  int d[MAX_DELTAS];
};

struct Plane {
  const float* x;
  long long sb, sh, sw;  // strides in elements
  __device__ __forceinline__ float at(int b, int i, int j) const {
    return __ldg(x + b * sb + i * sh + j * sw);
  }
};

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// denominator (|e| + |a|) + eps of the term from origin value a to end value e
__device__ __forceinline__ float denom(float a, float e, float eps) {
  return __fadd_rn(__fadd_rn(fabsf(e), fabsf(a)), eps);
}

// (gp - gg) of the term whose origin values are (pa, ga) and end values (pe, ge)
__device__ __forceinline__ float term_diff(float pa, float pe, float ga, float ge,
                                           float eps) {
  const float gp = __fdiv_rn(__fsub_rn(pe, pa), denom(pa, pe, eps));
  const float gg = __fdiv_rn(__fsub_rn(ge, ga), denom(ga, ge, eps));
  return __fsub_rn(gp, gg);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// grid (blocks, B): saved[b, i, j] = s(i, j); partials[b, blockIdx.x] = the block's sum of s.
__global__ void __launch_bounds__(THREADS)
sig_forward_kernel(Plane p, Plane g, int H, int W, Deltas dl, float eps_sig, float eps_l2,
                   float* __restrict__ saved, float* __restrict__ partials) {
  const int b = blockIdx.y;
  const long long px = (long long)blockIdx.x * THREADS + threadIdx.x;
  float s = 0.f;
  if (px < (long long)H * W) {
    const int i = (int)(px / W), j = (int)(px % W);
    const float p0 = p.at(b, i, j), g0 = g.at(b, i, j);
    float acc = 0.f;
    for (int k = 0; k < dl.n; ++k) {
      const int d = dl.d[k];
      if (j + d < W) {
        const float diff = term_diff(p0, p.at(b, i, j + d), g0, g.at(b, i, j + d), eps_sig);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
      if (i + d < H) {
        const float diff = term_diff(p0, p.at(b, i + d, j), g0, g.at(b, i + d, j), eps_sig);
        acc = __fadd_rn(acc, __fmul_rn(diff, diff));
      }
    }
    s = __fsqrt_rn(__fadd_rn(acc, eps_l2));
    saved[(long long)b * H * W + px] = s;
  }
  __shared__ float red[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const float v = warp_sum(s);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < THREADS / 32; ++w) total += red[w];
    partials[(long long)b * gridDim.x + blockIdx.x] = total;
  }
}

// One block: out = (sum of the n partials, in double, in a fixed order) / count.
__global__ void __launch_bounds__(FIN_THREADS)
sig_finish_kernel(const float* __restrict__ partials, long long n, double count,
                  float* __restrict__ out) {
  __shared__ double red[FIN_THREADS];
  double v = 0.0;
  for (long long k = threadIdx.x; k < n; k += FIN_THREADS) v += partials[k];
  red[threadIdx.x] = v;
  __syncthreads();
  for (int half = FIN_THREADS / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) red[threadIdx.x] += red[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) *out = (float)(red[0] / count);
}

// The contributions to pixel j of the term whose origin is j (a = this pixel's values,
// e = the end's) and of the term whose end is j (a = the origin's values, e = this pixel's).
struct Grad {
  float p, g;
  __device__ __forceinline__ void origin(float pa, float pe, float ga, float ge, float q,
                                         float eps) {
    const float vp = denom(pa, pe, eps), vg = denom(ga, ge, eps);
    const float gp = __fdiv_rn(__fsub_rn(pe, pa), vp);
    const float gg = __fdiv_rn(__fsub_rn(ge, ga), vg);
    const float w = __fmul_rn(__fsub_rn(gp, gg), q);
    p = __fsub_rn(p, __fdiv_rn(__fmul_rn(w, __fadd_rn(1.f, __fmul_rn(gp, sgn(pa)))), vp));
    g = __fadd_rn(g, __fdiv_rn(__fmul_rn(w, __fadd_rn(1.f, __fmul_rn(gg, sgn(ga)))), vg));
  }
  __device__ __forceinline__ void end(float pa, float pe, float ga, float ge, float q,
                                      float eps) {
    const float vp = denom(pa, pe, eps), vg = denom(ga, ge, eps);
    const float gp = __fdiv_rn(__fsub_rn(pe, pa), vp);
    const float gg = __fdiv_rn(__fsub_rn(ge, ga), vg);
    const float w = __fmul_rn(__fsub_rn(gp, gg), q);
    p = __fadd_rn(p, __fdiv_rn(__fmul_rn(w, __fsub_rn(1.f, __fmul_rn(gp, sgn(pe)))), vp));
    g = __fsub_rn(g, __fdiv_rn(__fmul_rn(w, __fsub_rn(1.f, __fmul_rn(gg, sgn(ge)))), vg));
  }
};

// grid (blocks, B): dp[b, i, j] (and dg, when given), contiguous [B, H, W].
__global__ void __launch_bounds__(THREADS)
sig_backward_kernel(Plane p, Plane g, int H, int W, Deltas dl, float eps_sig,
                    const float* __restrict__ saved, const float* __restrict__ ct,
                    float* __restrict__ dp, float* __restrict__ dg) {
  const int b = blockIdx.y;
  const long long px = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (px >= (long long)H * W) return;
  const int i = (int)(px / W), j = (int)(px % W);
  const long long n = (long long)gridDim.y * H * W;
  const float cn = __fdiv_rn(*ct, (float)n);
  const float* s = saved + (long long)b * H * W;
  const float p0 = p.at(b, i, j), g0 = g.at(b, i, j);
  const float q0 = __fdiv_rn(cn, s[px]);
  Grad acc{0.f, 0.f};
  for (int k = 0; k < dl.n; ++k) {
    const int d = dl.d[k];
    if (j + d < W) acc.origin(p0, p.at(b, i, j + d), g0, g.at(b, i, j + d), q0, eps_sig);
    if (j - d >= 0)
      acc.end(p.at(b, i, j - d), p0, g.at(b, i, j - d), g0,
              __fdiv_rn(cn, s[(long long)i * W + j - d]), eps_sig);
    if (i + d < H) acc.origin(p0, p.at(b, i + d, j), g0, g.at(b, i + d, j), q0, eps_sig);
    if (i - d >= 0)
      acc.end(p.at(b, i - d, j), p0, g.at(b, i - d, j), g0,
              __fdiv_rn(cn, s[(long long)(i - d) * W + j]), eps_sig);
  }
  dp[(long long)b * H * W + px] = acc.p;
  if (dg != nullptr) dg[(long long)b * H * W + px] = acc.g;
}

Plane make_plane(const void* x, long long sb, long long sh, long long sw) {
  return Plane{static_cast<const float*>(x), sb, sh, sw};
}

Deltas make_deltas(const int* deltas, int n) {
  Deltas dl{};
  dl.n = n < MAX_DELTAS ? n : MAX_DELTAS;
  for (int k = 0; k < dl.n; ++k) dl.d[k] = deltas[k];
  return dl;
}

}  // namespace

extern "C" {

// Blocks of the forward's first kernel for an H x W map: the partials buffer holds
// B * blocks floats.
int sig_l2_blocks(int H, int W) {
  return (int)(((long long)H * W + THREADS - 1) / THREADS);
}

// Most deltas one call takes.
int sig_l2_max_deltas() { return MAX_DELTAS; }

// p, g: [B,H,W] f32 planes with element strides (sbp, shp, swp) and (sbg, shg, swg);
// deltas: a host array of nd ints, 1 <= nd <= sig_l2_max_deltas(), each >= 1; saved: B*H*W
// floats (contiguous), written with s; partials: B * sig_l2_blocks(H, W) floats of scratch;
// out: one float. Launches both kernels on `stream`, returns the cudaError_t of the launches.
int sig_l2_forward_launch(const void* p, long long sbp, long long shp, long long swp,
                          const void* g, long long sbg, long long shg, long long swg,
                          int B, int H, int W, const int* deltas, int nd, float eps_sig,
                          float eps_l2, void* saved, void* partials, void* out,
                          void* stream) {
  if (nd < 1 || nd > MAX_DELTAS) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = sig_l2_blocks(H, W);
  sig_forward_kernel<<<dim3(blocks, B), THREADS, 0, st>>>(
      make_plane(p, sbp, shp, swp), make_plane(g, sbg, shg, swg), H, W,
      make_deltas(deltas, nd), eps_sig, eps_l2, static_cast<float*>(saved),
      static_cast<float*>(partials));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sig_finish_kernel<<<1, FIN_THREADS, 0, st>>>(static_cast<const float*>(partials),
                                              (long long)B * blocks,
                                              (double)B * H * W, static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// p, g, deltas, nd as above; saved: the forward's s; ct: the loss's cotangent, one float
// on the device; dp: a contiguous [B,H,W] f32 output; dg: the same for gt, or null when gt
// needs no gradient. Launches on `stream`, returns the cudaError_t of the launch.
int sig_l2_backward_launch(const void* p, long long sbp, long long shp, long long swp,
                           const void* g, long long sbg, long long shg, long long swg,
                           int B, int H, int W, const int* deltas, int nd, float eps_sig,
                           const void* saved, const void* ct, void* dp, void* dg,
                           void* stream) {
  if (nd < 1 || nd > MAX_DELTAS) return static_cast<int>(cudaErrorInvalidValue);
  sig_backward_kernel<<<dim3(sig_l2_blocks(H, W), B), THREADS, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      make_plane(p, sbp, shp, swp), make_plane(g, sbg, shg, swg), H, W,
      make_deltas(deltas, nd), eps_sig, static_cast<const float*>(saved),
      static_cast<const float*>(ct), static_cast<float*>(dp), static_cast<float*>(dg));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
