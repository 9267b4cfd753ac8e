// Scale-invariant-gradient L2 loss, forward and backward, for Hopper (sm_90a), f32: one
// launch each way for a whole group of (pred, gt) maps.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_losses.py:63 _sig_kernel
// (entry point sig_l2_fused, :116, launched from _sig_fused_impl, :81-97) and the XLA
// autodiff that was its backward (_sig_bwd, :126-131). For pred and gt [B,H,W] (C=1
// planes, each read through its batch, row and column strides) and deltas d_1..d_K:
//   per map f and term t = (d, axis): gf(i) = (f(i+d) - f(i)) / ((|f(i+d)| + |f(i)|) + eps_sig),
//     defined where i+d lies inside the image along the axis (else the term is 0);
//   acc(i) = sum over the terms, x before y for each delta, of (gp(i) - gg(i))^2;
//   term   = sum_i sqrt(acc(i) + eps_l2) / (B H W).
// A group is up to MAX_MAPS (pred, gt) pairs with one set of deltas and a coefficient
// each (a training step's scales): the forward writes every pair's term and total =
// sum_k coef_k term_k; the backward every pair's gradients for the cotangent ct * coef_k
// (+ the cotangent of term_k where the caller used it). Every product, sum and quotient is
// rounded on its own (__fmul_rn, __fadd_rn, __fdiv_rn, __fsqrt_rn: no contraction into
// FMAs), in the order of the plain version (ops/sig.py:sig_l2_plain) and of the gather
// formula (ops/sig_l2.py), so the backward is bit-equal to that formula.
//
// Forward: each pixel computes acc(i) and s(i) = sqrt(acc(i) + eps_l2), saves s(i) for
// the backward (one float a pixel, one flat buffer for the group) and adds s into its
// tile's slot; the last block to finish (a __threadfence and an atomic ticket) adds each
// map's slots in double in a fixed order, so the same inputs give the same bits on every
// run (no float atomics). The ticket is an unsigned int per (device, stream) that the
// wrapper allocates zeroed once (ops/_launch.py): it is 0 at every launch, because the
// last block resets it before it exits and launches on one stream run one after another;
// two streams hold two tickets, so they cannot race.
// Backward, in gather form, one thread per pixel j, no atomics: for every delta and axis
// the term whose origin is j (if j+d is inside) and the term whose end is j (if j-d is
// inside) each add, with q = (ct_k / (B H W)) / s(origin) and w = (gp - gg) q,
//   to dpred: origin -(w (1 + gp sgn(f(j)))) / vp,   end (w (1 - gp sgn(f(j)))) / vp,
//   to dgt:   origin  (w (1 + gg sgn(g(j)))) / vg,   end -(w (1 - gg sgn(g(j)))) / vg,
// where vp, vg are the terms' denominators; sgn(0) = 0, the derivative of |.| in PyTorch.
//
// Design. With one call a scale, the host's cost of a call was ~97 % of a split_training
// phase-2 step's sig unit (4 + 4 calls, 8 + 4 kernels). So a group is one launch each way;
// its descriptors and deltas go to the kernel by value (a __grid_constant__ struct); the
// maps are cut into tiles of TH x TW pixels of one image, listed map after map, and
// min(tiles, BLOCKS_PER_SM x SMs) persistent blocks walk that list. A block stages pred,
// gt (and, backward, s) of its tile with a halo into shared memory once: NEAR_X columns on
// each side and NEAR_Y rows (forward: right and below only). A term of a delta up to
// NEAR_X along x, or NEAR_Y along y, reads shared memory; the y-terms of longer deltas
// (4, 8, 16 in the 5-delta call) read L2, where the neighbouring bands bring those rows.
// Why not stage +-16 rows: a 16-row tile would then read 48 rows (3x), and its three boxes
// would take 3 x 48 x 160 x 4 B = 92 KB of shared memory, two blocks an SM; the training
// path's calls are delta 2, all of whose terms lie in the 20 x 160 box. Rows of a
// column-stride-1 plane that start on 16 bytes are staged with 16-byte loads.
//
// Bound on an H100 SXM, a split_training phase-2 group (4 pairs, B=1, 192x256 down to
// 24x32, delta 2; 65,280 pixels): pred and gt read once, 0.52 MB, 0.16 us forward; read
// and d pred written, 0.78 MB, 0.23 us backward; bytes bound both, and at this size the
// launch itself is longer. The 5-delta call at 192x256, B=8 (393,216 pixels, ~3.8 M terms):
// the forward must read pred and gt once (3.1 MB, 0.94 us at 3.35 TB/s) for ~15 float32
// operations a term (0.87 us at 67 TFLOP/s), so bytes bound it; the backward must read
// them and write d pred (4.7 MB, 1.41 us) for ~24 operations a term (1.38 us), so bytes
// bound it too: 2.35 us for the pair (chip_smoke.py:sig_bound). Reading the saved s and
// computing each term at both of its ends are this design's own costs, above that bound.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int TH = 16, TW = 128;   // a tile: TH rows x TW columns of one image
constexpr int MAX_MAPS = 8;
constexpr int MAX_DELTAS = 8;
constexpr int BLOCKS_PER_SM = 4;
constexpr int NEAR_Y = 2, NEAR_X = 16;  // staged halo rows and columns (a multiple of 4)
// the staged box, row pitch BOX_W: forward rows [i0, i0 + TH + NEAR_Y) and columns
// [j0, j0 + TW + NEAR_X); backward rows [i0 - NEAR_Y, i0 + TH + NEAR_Y) and columns
// [j0 - NEAR_X, j0 + TW + NEAR_X)
constexpr int BOX_H = TH + 2 * NEAR_Y, BOX_W = TW + 2 * NEAR_X;

struct Plane {
  const float* x;
  long long sb, sh, sw;  // strides in elements
};

// One (pred, gt) pair of a group, packed by ops/sig_l2.py:_MAP.
struct MapDesc {
  Plane p, g;
  long long out_off;     // the map's first pixel in the flat s and gradient buffers
  int B, H, W;
  int first_tile;        // the map's first tile in the group's list
  int bands, strips;     // tiles of an image: ceil(H / TH) x ceil(W / TW)
  float coef;
  int vec;               // bit 0: p, bit 1: g has sw == 1 and rows that start on 16 bytes
};
static_assert(sizeof(MapDesc) == 104 && offsetof(MapDesc, B) == 72 &&
              offsetof(MapDesc, coef) == 96, "MapDesc is packed by ops/sig_l2.py");

// packed by ops/sig_l2.py:_HEAD
struct Group {
  int n_maps, n_tiles, nd;
  float eps_sig, eps_l2;
  int pad;
  int d[MAX_DELTAS];
  MapDesc maps[MAX_MAPS];
};
static_assert(offsetof(Group, maps) == 56, "Group is packed by ops/sig_l2.py");

struct Tile {
  int k, b, i0, j0;  // map, image, first row and column
};

__device__ __forceinline__ Tile locate(const Group& g, int t) {
  int k = 0;
  while (k + 1 < g.n_maps && t >= g.maps[k + 1].first_tile) ++k;
  const MapDesc& m = g.maps[k];
  const int local = t - m.first_tile, per_image = m.bands * m.strips;
  const int r = local % per_image;
  return Tile{k, local / per_image, (r / m.strips) * TH, (r % m.strips) * TW};
}

__device__ __forceinline__ float load(const float* row, long long sw, int j, int W) {
  return (j >= 0 && j < W) ? __ldg(row + j * sw) : 0.f;
}

// Rows [r0, r0 + nr) and columns [c0, c0 + nc) of an image (its first element img, row
// and column strides sh and sw, H x W) into box (row pitch BOX_W), zeros outside the
// image; c0 and nc are multiples of 4; vec: 16-byte loads are allowed.
__device__ __forceinline__ void stage(const float* img, long long sh, long long sw, int H,
                                      int W, bool vec, int r0, int nr, int c0, int nc,
                                      float* box) {
  const int words = nc / 4;
  for (int e = threadIdx.x; e < nr * words; e += THREADS) {
    const int r = e / words, q = e % words;
    const int i = r0 + r, j = c0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= 0 && i < H) {
      const float* row = img + i * sh;
      if (vec && j >= 0 && j + 4 <= W)
        v = __ldg(reinterpret_cast<const float4*>(row + j));
      else
        v = make_float4(load(row, sw, j, W), load(row, sw, j + 1, W), load(row, sw, j + 2, W),
                        load(row, sw, j + 3, W));
    }
    *reinterpret_cast<float4*>(box + r * BOX_W + 4 * q) = v;
  }
}

// A value at map coordinates (i, j) of image b: from the staged box where the term is
// near, else from memory (L2).
struct Source {
  const float* box;
  int i0, j0;            // the map coordinates of box[0]
  const float* img;      // image b's first element
  long long sh, sw;
  __device__ __forceinline__ float near(int i, int j) const {
    return box[(i - i0) * BOX_W + (j - j0)];
  }
  __device__ __forceinline__ float far(int i, int j) const {
    return __ldg(img + i * sh + j * sw);
  }
  __device__ __forceinline__ float x(int i, int j, int d) const {  // a term along x
    return d <= NEAR_X ? near(i, j) : far(i, j);
  }
  __device__ __forceinline__ float y(int i, int j, int d) const {  // a term along y
    return d <= NEAR_Y ? near(i, j) : far(i, j);
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

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The last block: each map's sum of s over its tiles in double (thread t takes tiles t,
// t + THREADS, ...; then the lanes' and warps' sums in a fixed order), term_k = sum /
// (B H W) into out[1 + k], and out[0] = sum_k coef_k term_k in map order.
__device__ void finish(const Group& g, const float* slots, float* out) {
  __shared__ double red[THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double total = 0.0;  // thread 0's
  for (int k = 0; k < g.n_maps; ++k) {
    const MapDesc& m = g.maps[k];
    const int n = m.B * m.bands * m.strips;
    double v = 0.0;
    for (int t = threadIdx.x; t < n; t += THREADS) v += (double)__ldcg(slots + m.first_tile + t);
    v = warp_sum(v);
    if (lane == 0) red[warp] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int w = 0; w < THREADS / 32; ++w) s += red[w];
      const float tk = (float)(s / ((double)m.B * m.H * m.W));
      out[1 + k] = tk;
      total += (double)m.coef * (double)tk;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)total;
}

// s_out: each map's [B,H,W] s, contiguous, from out_off; slots[t]: tile t's sum of s; out:
// total, then each map's term; ticket: 0.
__global__ void __launch_bounds__(THREADS)
sig_group_forward(const __grid_constant__ Group g, float* __restrict__ s_out,
                  float* __restrict__ slots, float* __restrict__ out,
                  unsigned int* __restrict__ ticket) {
  __shared__ __align__(16) float bp[(TH + NEAR_Y) * BOX_W];
  __shared__ __align__(16) float bg[(TH + NEAR_Y) * BOX_W];
  __shared__ float red[THREADS / 32];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = locate(g, t);
    const MapDesc& m = g.maps[tl.k];
    const int H = m.H, W = m.W;
    const float* pimg = m.p.x + tl.b * m.p.sb;
    const float* gimg = m.g.x + tl.b * m.g.sb;
    stage(pimg, m.p.sh, m.p.sw, H, W, m.vec & 1, tl.i0, TH + NEAR_Y, tl.j0, TW + NEAR_X, bp);
    stage(gimg, m.g.sh, m.g.sw, H, W, m.vec & 2, tl.i0, TH + NEAR_Y, tl.j0, TW + NEAR_X, bg);
    __syncthreads();
    const Source P{bp, tl.i0, tl.j0, pimg, m.p.sh, m.p.sw};
    const Source G{bg, tl.i0, tl.j0, gimg, m.g.sh, m.g.sw};
    float* s_img = s_out + m.out_off + (long long)tl.b * H * W;
    float part = 0.f;
    for (int r = warp; r < TH; r += THREADS / 32) {
      const int i = tl.i0 + r;
      for (int c = lane; c < TW; c += 32) {
        const int j = tl.j0 + c;
        if (i >= H || j >= W) continue;
        const float p0 = P.near(i, j), g0 = G.near(i, j);
        float acc = 0.f;
        for (int k = 0; k < g.nd; ++k) {
          const int d = g.d[k];
          if (j + d < W) {
            const float diff = term_diff(p0, P.x(i, j + d, d), g0, G.x(i, j + d, d), g.eps_sig);
            acc = __fadd_rn(acc, __fmul_rn(diff, diff));
          }
          if (i + d < H) {
            const float diff = term_diff(p0, P.y(i + d, j, d), g0, G.y(i + d, j, d), g.eps_sig);
            acc = __fadd_rn(acc, __fmul_rn(diff, diff));
          }
        }
        const float s = __fsqrt_rn(__fadd_rn(acc, g.eps_l2));
        s_img[(long long)i * W + j] = s;
        part += s;
      }
    }
    part = warp_sum(part);
    if (lane == 0) red[warp] = part;
    __syncthreads();  // also: every read of the boxes is done before the next tile's stage
    if (threadIdx.x == 0) {
      float acc = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) acc += red[w];
      slots[t] = acc;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish(g, slots, out);
  if (threadIdx.x == 0) *ticket = 0u;
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

// s_in: the forward's s; ct: the total's cotangent, or null; ct_maps[k * ct_stride]: term
// k's, or null; dp, dg: each map's [B,H,W] gradients, contiguous, from out_off (dg null:
// no gt needs one).
__global__ void __launch_bounds__(THREADS)
sig_group_backward(const __grid_constant__ Group g, const float* __restrict__ s_in,
                   const float* __restrict__ ct, const float* __restrict__ ct_maps,
                   long long ct_stride, float* __restrict__ dp, float* __restrict__ dg) {
  __shared__ __align__(16) float bp[BOX_H * BOX_W];
  __shared__ __align__(16) float bg[BOX_H * BOX_W];
  __shared__ __align__(16) float bs[BOX_H * BOX_W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = locate(g, t);
    const MapDesc& m = g.maps[tl.k];
    const int B = m.B, H = m.H, W = m.W;
    const long long img_off = m.out_off + (long long)tl.b * H * W;
    const float* pimg = m.p.x + tl.b * m.p.sb;
    const float* gimg = m.g.x + tl.b * m.g.sb;
    const int r0 = tl.i0 - NEAR_Y, c0 = tl.j0 - NEAR_X;
    __syncthreads();  // the previous tile's reads of the boxes are done
    stage(pimg, m.p.sh, m.p.sw, H, W, m.vec & 1, r0, BOX_H, c0, BOX_W, bp);
    stage(gimg, m.g.sh, m.g.sw, H, W, m.vec & 2, r0, BOX_H, c0, BOX_W, bg);
    // s is contiguous from out_off, a multiple of 4: its rows start on 16 bytes when W is
    stage(s_in + img_off, W, 1, H, W, W % 4 == 0, r0, BOX_H, c0, BOX_W, bs);
    __syncthreads();
    const Source P{bp, r0, c0, pimg, m.p.sh, m.p.sw};
    const Source G{bg, r0, c0, gimg, m.g.sh, m.g.sw};
    const Source S{bs, r0, c0, s_in + img_off, W, 1};
    float c = ct != nullptr ? __fmul_rn(*ct, m.coef) : 0.f;
    if (ct_maps != nullptr) c = __fadd_rn(c, ct_maps[tl.k * ct_stride]);
    const float cn = __fdiv_rn(c, (float)((long long)B * H * W));
    const float eps = g.eps_sig;
    for (int r = warp; r < TH; r += THREADS / 32) {
      const int i = tl.i0 + r;
      for (int cc = lane; cc < TW; cc += 32) {
        const int j = tl.j0 + cc;
        if (i >= H || j >= W) continue;
        const float p0 = P.near(i, j), g0 = G.near(i, j);
        const float q0 = __fdiv_rn(cn, S.near(i, j));
        Grad acc{0.f, 0.f};
        for (int k = 0; k < g.nd; ++k) {
          const int d = g.d[k];
          if (j + d < W) acc.origin(p0, P.x(i, j + d, d), g0, G.x(i, j + d, d), q0, eps);
          if (j - d >= 0)
            acc.end(P.x(i, j - d, d), p0, G.x(i, j - d, d), g0,
                    __fdiv_rn(cn, S.x(i, j - d, d)), eps);
          if (i + d < H) acc.origin(p0, P.y(i + d, j, d), g0, G.y(i + d, j, d), q0, eps);
          if (i - d >= 0)
            acc.end(P.y(i - d, j, d), p0, G.y(i - d, j, d), g0,
                    __fdiv_rn(cn, S.y(i - d, j, d)), eps);
        }
        dp[img_off + (long long)i * W + j] = acc.p;
        if (dg != nullptr) dg[img_off + (long long)i * W + j] = acc.g;
      }
    }
  }
}

// The group packed at desc (its header, then n_maps MapDescs), or false when it holds no
// map, more than MAX_MAPS, or a delta count outside [1, MAX_DELTAS].
bool read_group(const void* desc, Group* g) {
  std::memset(g, 0, sizeof(Group));
  std::memcpy(g, desc, offsetof(Group, maps));
  if (g->n_maps < 1 || g->n_maps > MAX_MAPS || g->n_tiles < 1 || g->nd < 1 ||
      g->nd > MAX_DELTAS)
    return false;
  std::memcpy(g->maps, static_cast<const char*>(desc) + offsetof(Group, maps),
              g->n_maps * sizeof(MapDesc));
  return true;
}

int blocks_for(int tiles) {
  static int sms[64] = {0};
  int dev = 0;
  cudaGetDevice(&dev);
  int n = dev < 64 ? sms[dev] : 0;
  if (n == 0) {
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (dev < 64) sms[dev] = n;
  }
  return tiles < BLOCKS_PER_SM * n ? tiles : BLOCKS_PER_SM * n;
}

}  // namespace

extern "C" {

// The tile (rows, columns) the wrapper cuts the maps into, the most maps a group takes and
// the most deltas.
void sig_l2_layout(int* th, int* tw, int* max_maps, int* max_deltas) {
  *th = TH;
  *tw = TW;
  *max_maps = MAX_MAPS;
  *max_deltas = MAX_DELTAS;
}

// desc: the packed group; s: the flat s buffer (each map's pixels from its out_off);
// slots: 1 float a tile of scratch; out: 1 + n_maps floats (the total, then each map's
// term); ticket: the stream's zeroed unsigned int. Launches on `stream` and returns the
// cudaError_t of the launch (cudaErrorInvalidValue for a bad group).
int sig_l2_group_forward(const void* desc, void* s, void* slots, void* out, void* ticket,
                         void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  sig_group_forward<<<blocks_for(g.n_tiles), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<float*>(s), static_cast<float*>(slots), static_cast<float*>(out),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// desc, s as above; ct: the total's cotangent, one float on the device, or null; ct_maps:
// the terms' cotangents, n_maps floats ct_stride apart, or null; dp, dg: the flat
// gradients of pred and gt (dg null when no gt needs one). Launches on `stream`, returns
// the cudaError_t of the launch.
int sig_l2_group_backward(const void* desc, const void* s, const void* ct,
                          const void* ct_maps, long long ct_stride, void* dp, void* dg,
                          void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  sig_group_backward<<<blocks_for(g.n_tiles), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float*>(s), static_cast<const float*>(ct),
      static_cast<const float*>(ct_maps), ct_stride, static_cast<float*>(dp),
      static_cast<float*>(dg));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
