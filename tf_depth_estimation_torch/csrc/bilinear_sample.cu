// Bilinear sampling with the reference border rule for Hopper (sm_90a), f32: one forward and
// one backward launch for a whole group of samplings (the warps of a training step).
//
// Replaces both TPU samplers, which compute one function:
//   * tf_depth_estimation_tpu/ops/pallas_sample.py:97 _sample_kernel (entry point
//     bilinear_sample_tpu, :255) with the XLA prologue that fed it (_prologue, :69), whose
//     backward was XLA code over four saved corner planes (:269-310);
//   * tf_depth_estimation_tpu/ops/pallas_warp.py:51 _warp_kernel (entry point
//     bilinear_sample_fused, :144, pallas_call at :114), whose backward was XLA autodiff
//     of the plain sampler (:153-156).
// A member of a group samples imgs [B,Hs,Ws,C] at coords [B,Ht,Wt,2] (x, y), both f32 NHWC,
// and writes, per target pixel,
//   x0 = floor(x), x1 = x0 + 1, each clamped to [0, Ws-1] for the gather (y alike)
//   wx0 = x0 unclamped inside ? x1 - x : 0,  wx1 = x1 inside ? x - x0 : 0  (wy alike)
//   out   = w00*im00 + w01*im01 + w10*im10 + w11*im11,  w_ab = wx_a * wy_b
//   wmask = w00 + w01 + w10 + w11
// The backward recomputes the four taps from imgs and coords (no corner planes are ever
// written) and writes, for a member whose coords need a gradient,
//   s_ab  = sum_c dout_c * im_ab_c + dwmask                  (c = 0, 1, ... in order)
//   gwx0  = s00*wy0 + s01*wy1,  gwx1 = s10*wy0 + s11*wy1    (gwy alike, with wx)
//   dx    = gwx1*[x1 inside] - gwx0*[x0 inside]             (dy alike); floor and the
//                                                           clamps have zero gradient
// and, for a member whose image needs a gradient, scatters dimgs[tap] += w_ab * dout_c with
// atomicAdd into a buffer the wrapper zeroes (so its sum order differs from run to run, as
// scatter_add_'s does); dcoords has no atomics, so two runs give the same bits. A null dout
// or dwmask reads as zeros. Every product and sum is rounded on its own (__fmul_rn,
// __fadd_rn, never contracted into an FMA) in the reference's order, so out and wmask are
// bit-equal to the plain PyTorch version on the card; the backward sums the channels in
// order where PyTorch's autograd may take another, within float32 rounding.
//
// A tap whose unclamped index is outside weighs exactly 0, a select as in JAX (whose product
// of a weight and a boolean is one), so a NaN or infinite coordinate (a disparity that
// underflows to 0) gives out 0, wmask 0 and dcoords 0 where that tap is concerned, as in
// the reference; the integer tap index is clamped with fminf/fmaxf, which return the other
// operand for a NaN, so such a coordinate still gathers inside the image.
//
// Design. Called once a sampling, the host's cost of a call bounded the unit: a config-4
// step made 12 forward launches and 8 plain-PyTorch backwards over corner planes, a
// config-3 step 4 + 4 launches. So a group is one launch each way. Its members' descriptors
// go to the kernel by value (a __grid_constant__ struct); each member's target pixels are
// cut into tiles of TILE pixels, and min(tiles, resident blocks) persistent blocks walk the
// group's tile list. The members that sample one image (config 4's three warps of a scale
// read the same image) form a set whose tiles are interleaved tile by tile, so that the
// image is read from L2 by all three (12.9 MB at config 4's scale 0, of a 50 MB L2). A
// thread takes two adjacent target pixels: coords come in one 16-byte load where the
// member's coords (and dcoords) start on 16 bytes; adjacent threads take adjacent pixels,
// so coords, wmask, dout and dcoords coalesce, a tile's out leaves from shared memory in
// 16-byte stores, and the taps are gathered through L1, where a real warp's neighbouring
// pixels find the lines their neighbours loaded. The backward gives no tiles to a member
// that needs no gradient (the wrapper leaves it out).
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32). Config 4's 12 samplings of a step
// (B=10, C=3, 224x480 down to 28x60, 1,428,000 target pixels a warp, three warps of each
// image): counted a sampling at a time, the forward reads imgs (12 B a target pixel) and
// coords (8) and writes out (12) and wmask (4), 36 B x 4,284,000 = 154.2 MB, 46.0 us; as
// one group that reads each of the 4 images once, 119.9 MB, 35.8 us. The backward of the 8
// warps with dcoords reads imgs, coords and dout and writes dcoords, 40 B a pixel counted a
// sampling at a time (114.2 MB, 34.1 us), 97.1 MB as a group (29.0 us). Config 3's 4 + 4
// (B=16, 192x256 down to 24x32, 1,044,480 target pixels, each image read by one warp):
// 37.6 + 41.8 MB, 11.2 + 12.5 us. About 40 and 63 operations a pixel take 2.6 and 2.7 us
// for config 4 at the f32 rate. Bytes bound both ways.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr int THREADS = 256;
constexpr int PIX = 2;               // target pixels a thread
constexpr int TILE = THREADS * PIX;  // target pixels a tile
constexpr int MAX_MEMBERS = 16;
constexpr int STAGE_C = 4;           // the forward stages a tile's out up to this many channels

// One member of a group, packed by ops/bilinear_sample.py:_MEMBER. The forward reads imgs
// and coords and writes out and wmask; the backward reads imgs, coords, dout and dwmask and
// writes dcoords and dimgs (each may be null).
struct Member {
  const float* imgs;    // [B,Hs,Ws,C]
  const float* coords;  // [B,Ht,Wt,2]
  float* out;           // [B,Ht,Wt,C]
  float* wmask;         // [B,Ht,Wt]
  const float* dout;    // [B,Ht,Wt,C] or null (zeros)
  const float* dwmask;  // [B,Ht,Wt] or null (zeros)
  float* dcoords;       // [B,Ht,Wt,2] or null (not computed)
  float* dimgs;         // [B,Hs,Ws,C] zeroed by the caller, or null (not computed)
  long long n;          // target pixels, B * Ht * Wt
  int Hs, Ws, C;
  int hw;               // target pixels an image, Ht * Wt
  int first_tile;       // the first tile of the member's set in the group's list
  int ways;             // members in the set, whose tiles alternate
  int lane;             // the member's place in its set
  int vec;              // 1: coords (and dcoords) start on 16 bytes
  int pad[2];
};
static_assert(sizeof(Member) == 112 && offsetof(Member, n) == 64 &&
              offsetof(Member, Hs) == 72 && offsetof(Member, first_tile) == 88,
              "Member is packed by ops/bilinear_sample.py");

struct Group {
  int n_members, n_tiles;
  Member m[MAX_MEMBERS];
};

// The member of tile t and the tile's place among the member's own tiles. The members of a
// set share first_tile, so the scan stops at its last member, whose lane is ways - 1.
__device__ __forceinline__ int locate(const Group& g, int t, int* local) {
  int k = 0;
  while (k + 1 < g.n_members && t >= g.m[k + 1].first_tile) ++k;
  const Member& last = g.m[k];
  const int r = t - last.first_tile;
  *local = r / last.ways;
  return k - last.lane + r % last.ways;
}

// The prologue shared by both kernels: weights, inside flags and clamped tap offsets.
struct Taps {
  float wx0, wx1, wy0, wy1;      // weights, zero where the unclamped tap is outside
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
  // a select, not a product with the flag: 0 for an outside tap even at a NaN coordinate
  t.wx0 = x0 == x0s ? __fsub_rn(x1, cx) : 0.f;
  t.wx1 = x1 == x1s ? __fsub_rn(cx, x0) : 0.f;
  t.wy0 = y0 == y0s ? __fsub_rn(y1, cy) : 0.f;
  t.wy1 = y1 == y1s ? __fsub_rn(cy, y0) : 0.f;
  const long long ix0 = (int)x0s, ix1 = (int)x1s, iy0 = (int)y0s, iy1 = (int)y1s;
  t.o00 = (iy0 * Ws + ix0) * C;
  t.o01 = (iy1 * Ws + ix0) * C;
  t.o10 = (iy0 * Ws + ix1) * C;
  t.o11 = (iy1 * Ws + ix1) * C;
  return t;
}

// The coords of pixels p and p + 1 (the second only when `two`): one 16-byte load where
// the member's coords start on 16 bytes (p is even), else scalar loads.
__device__ __forceinline__ float4 load_coords(const Member& m, long long p, bool two) {
  if (m.vec && two) return __ldg(reinterpret_cast<const float4*>(m.coords + 2 * p));
  float4 c;
  c.x = __ldg(m.coords + 2 * p);
  c.y = __ldg(m.coords + 2 * p + 1);
  c.z = two ? __ldg(m.coords + 2 * p + 2) : 0.f;
  c.w = two ? __ldg(m.coords + 2 * p + 3) : 0.f;
  return c;
}

__device__ __forceinline__ const float* image_of(const Member& m, long long p) {
  return m.imgs + (p / m.hw) * (long long)m.Hs * m.Ws * m.C;
}

// Pixel p's C channels of out into `out`; returns its wmask.
__device__ __forceinline__ float forward_pixel(const Member& m, long long p, float cx,
                                               float cy, float* out) {
  const Taps t = taps(cx, cy, m.Hs, m.Ws, m.C);
  const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
  const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
  const float* img = image_of(m, p);
  for (int c = 0; c < m.C; ++c) {
    float acc = __fmul_rn(w00, __ldg(img + t.o00 + c));
    acc = __fadd_rn(acc, __fmul_rn(w01, __ldg(img + t.o01 + c)));
    acc = __fadd_rn(acc, __fmul_rn(w10, __ldg(img + t.o10 + c)));
    acc = __fadd_rn(acc, __fmul_rn(w11, __ldg(img + t.o11 + c)));
    out[c] = acc;
  }
  return __fadd_rn(__fadd_rn(__fadd_rn(w00, w01), w10), w11);
}

// dcoords of pixel p as (dx, dy) when the member computes it; scatters dimgs when it does.
__device__ __forceinline__ float2 backward_pixel(const Member& m, long long p, float cx,
                                                 float cy) {
  const Taps t = taps(cx, cy, m.Hs, m.Ws, m.C);
  const float* dout = m.dout != nullptr ? m.dout + p * m.C : nullptr;
  float2 d = make_float2(0.f, 0.f);
  if (m.dcoords != nullptr) {
    const float* img = image_of(m, p);
    float s00 = 0.f, s01 = 0.f, s10 = 0.f, s11 = 0.f;
    for (int c = 0; c < m.C; ++c) {
      const float g = dout != nullptr ? dout[c] : 0.f;
      const float a00 = __fmul_rn(g, __ldg(img + t.o00 + c));
      const float a01 = __fmul_rn(g, __ldg(img + t.o01 + c));
      const float a10 = __fmul_rn(g, __ldg(img + t.o10 + c));
      const float a11 = __fmul_rn(g, __ldg(img + t.o11 + c));
      s00 = c == 0 ? a00 : __fadd_rn(s00, a00);
      s01 = c == 0 ? a01 : __fadd_rn(s01, a01);
      s10 = c == 0 ? a10 : __fadd_rn(s10, a10);
      s11 = c == 0 ? a11 : __fadd_rn(s11, a11);
    }
    if (m.dwmask != nullptr) {
      const float dm = m.dwmask[p];
      s00 = __fadd_rn(s00, dm);
      s01 = __fadd_rn(s01, dm);
      s10 = __fadd_rn(s10, dm);
      s11 = __fadd_rn(s11, dm);
    }
    const float gwx0 = __fadd_rn(__fmul_rn(s00, t.wy0), __fmul_rn(s01, t.wy1));
    const float gwx1 = __fadd_rn(__fmul_rn(s10, t.wy0), __fmul_rn(s11, t.wy1));
    const float gwy0 = __fadd_rn(__fmul_rn(s00, t.wx0), __fmul_rn(s10, t.wx1));
    const float gwy1 = __fadd_rn(__fmul_rn(s01, t.wx0), __fmul_rn(s11, t.wx1));
    d.x = __fsub_rn(__fmul_rn(gwx1, t.inx1), __fmul_rn(gwx0, t.inx0));
    d.y = __fsub_rn(__fmul_rn(gwy1, t.iny1), __fmul_rn(gwy0, t.iny0));
  }
  if (m.dimgs != nullptr && dout != nullptr) {
    float* dimg = m.dimgs + (p / m.hw) * (long long)m.Hs * m.Ws * m.C;
    const float w00 = __fmul_rn(t.wx0, t.wy0), w01 = __fmul_rn(t.wx0, t.wy1);
    const float w10 = __fmul_rn(t.wx1, t.wy0), w11 = __fmul_rn(t.wx1, t.wy1);
    for (int c = 0; c < m.C; ++c) {
      const float g = dout[c];
      atomicAdd(dimg + t.o00 + c, __fmul_rn(w00, g));
      atomicAdd(dimg + t.o01 + c, __fmul_rn(w01, g));
      atomicAdd(dimg + t.o10 + c, __fmul_rn(w10, g));
      atomicAdd(dimg + t.o11 + c, __fmul_rn(w11, g));
    }
  }
  return d;
}

// A tile's out goes through shared memory when a member has at most STAGE_C channels: a
// thread's own pixels lie C floats apart in out (24 bytes at C = 3), and stored straight
// from each thread those stores took half the launch (tools/sampler_variants.py); staged,
// the tile leaves in 16-byte stores, neighbouring threads on neighbouring addresses.
__global__ void __launch_bounds__(THREADS)
bilinear_group_forward(const __grid_constant__ Group g) {
  __shared__ __align__(16) float stage[TILE * STAGE_C];
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    int local;
    const Member& m = g.m[locate(g, t, &local)];  // one member a tile: uniform in the block
    const long long p0 = (long long)local * TILE, p = p0 + PIX * threadIdx.x;
    const bool staged = m.C <= STAGE_C;
    if (p < m.n) {
      const bool two = p + 1 < m.n;
      const float4 c = load_coords(m, p, two);
      float* out = staged ? stage + PIX * threadIdx.x * m.C : m.out + p * m.C;
      const float w0 = forward_pixel(m, p, c.x, c.y, out);
      const float w1 = two ? forward_pixel(m, p + 1, c.z, c.w, out + m.C) : 0.f;
      if (two && (reinterpret_cast<uintptr_t>(m.wmask + p) & 7) == 0) {
        *reinterpret_cast<float2*>(m.wmask + p) = make_float2(w0, w1);
      } else {
        m.wmask[p] = w0;
        if (two) m.wmask[p + 1] = w1;
      }
    }
    if (!staged) continue;
    __syncthreads();
    // the tile's out is one run of floats from out + p0 C, which starts on 16 bytes when
    // out does (p0 is a multiple of TILE)
    const int count = (int)(m.n - p0 < TILE ? m.n - p0 : TILE) * m.C;
    float* out = m.out + p0 * m.C;
    if ((reinterpret_cast<uintptr_t>(out) & 15) == 0) {
      for (int e = 4 * threadIdx.x; e < count; e += 4 * THREADS) {
        if (e + 4 <= count) {
          *reinterpret_cast<float4*>(out + e) = *reinterpret_cast<const float4*>(stage + e);
        } else {
          for (int q = e; q < count; ++q) out[q] = stage[q];
        }
      }
    } else {
      for (int e = threadIdx.x; e < count; e += THREADS) out[e] = stage[e];
    }
    __syncthreads();  // the stage is read before the next tile writes it
  }
}

// 4 blocks a SM: the compiler keeps it to 64 registers (72 unbounded, 3 blocks a SM), which
// made the launch 8 % faster on config 4's warps (tools/sampler_variants.py)
__global__ void __launch_bounds__(THREADS, 4)
bilinear_group_backward(const __grid_constant__ Group g) {
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    int local;
    const Member& m = g.m[locate(g, t, &local)];
    const long long p = (long long)local * TILE + PIX * threadIdx.x;
    if (p >= m.n) continue;
    const bool two = p + 1 < m.n;
    const float4 c = load_coords(m, p, two);
    const float2 d0 = backward_pixel(m, p, c.x, c.y);
    const float2 d1 = two ? backward_pixel(m, p + 1, c.z, c.w) : make_float2(0.f, 0.f);
    if (m.dcoords == nullptr) continue;
    if (m.vec && two) {
      *reinterpret_cast<float4*>(m.dcoords + 2 * p) = make_float4(d0.x, d0.y, d1.x, d1.y);
    } else {
      m.dcoords[2 * p] = d0.x;
      m.dcoords[2 * p + 1] = d0.y;
      if (two) {
        m.dcoords[2 * p + 2] = d1.x;
        m.dcoords[2 * p + 3] = d1.y;
      }
    }
  }
}

// The group packed at desc (an (n_members, n_tiles) int pair, then n_members Members), or
// false when it holds no member, more than MAX_MEMBERS or no tile.
bool read_group(const void* desc, Group* g) {
  std::memset(g, 0, sizeof(Group));
  std::memcpy(g, desc, offsetof(Group, m));
  if (g->n_members < 1 || g->n_members > MAX_MEMBERS || g->n_tiles < 1) return false;
  std::memcpy(g->m, static_cast<const char*>(desc) + offsetof(Group, m),
              g->n_members * sizeof(Member));
  return true;
}

// min(tiles, the blocks of `kernel` that the card holds at once), per device and kernel.
int blocks_for(const void* kernel, int which, int tiles) {
  static int resident[2][64] = {{0}};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < 64 ? resident[which][dev] : 0;
  if (n == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
    if (dev < 64) resident[which][dev] = n;
  }
  return tiles < n ? tiles : n;
}

}  // namespace

extern "C" {

// The target pixels of a tile and the most members a group takes.
void bilinear_group_layout(int* tile, int* max_members) {
  *tile = TILE;
  *max_members = MAX_MEMBERS;
}

// desc: the packed group (out and wmask set in each member). Launches on `stream` and
// returns the cudaError_t of the launch (cudaErrorInvalidValue for a bad group).
int bilinear_group_forward_launch(const void* desc, void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const void* k = reinterpret_cast<const void*>(bilinear_group_forward);
  bilinear_group_forward<<<blocks_for(k, 0, g.n_tiles), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// desc: the packed group of the members that need a gradient (dout, dwmask, dcoords and
// dimgs set in each, any of them null). Launches on `stream` and returns the cudaError_t of
// the launch.
int bilinear_group_backward_launch(const void* desc, void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  const void* k = reinterpret_cast<const void*>(bilinear_group_backward);
  bilinear_group_backward<<<blocks_for(k, 1, g.n_tiles), THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
