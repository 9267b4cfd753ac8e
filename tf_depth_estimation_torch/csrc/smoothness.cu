// Second-order smoothness of depth and flow maps, forward and backward, for Hopper
// (sm_90a), f32: one launch each way for a whole group of maps.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_losses.py:140 _smooth_kernel
// (entry point smoothness_fused, :182) and the XLA autodiff that was its backward (:191).
// For a map x [B,H,W] (a C=1 plane, read through its batch, row and column strides) it
// computes, with dx = x[i,j+1]-x[i,j] and dy = x[i+1,j]-x[i,j],
//   term = 1/B sum_b ( sum|dx[i,j+1]-dx[i,j]| / (H(W-2)) + sum|dy[i+1,j]-dy[i,j]| / ((H-2)W)
//                    + sum|dx[i+1,j]-dx[i,j]| / ((H-1)(W-1))
//                    + sum|dy[i,j+1]-dy[i,j]| / ((H-1)(W-1)) )
// A group is up to MAX_MAPS maps, each with a coefficient (a training step's scales and
// planes): the forward writes every map's term and total = sum_k coef_k term_k; the
// backward every map's gradient for the cotangent ct * coef_k (+ the cotangent of term_k
// where the caller used it). Every difference is formed in the plain version's operand
// order, so each term has the plain version's bits and its sign, which decides the
// gradient, too: the two mixed terms are equal in exact arithmetic but not always in float.
//
// Design. With one call a map, the host's cost of a call bounded the term: a config-4 step
// made 12 + 12 calls (36 kernels, and as many checks, allocations, autograd nodes and ctypes
// calls), and four fifths of the unit's time was the host's. So a group is one launch each
// way. Its descriptors go to the kernel by value (a __grid_constant__ struct); the maps are
// cut into tiles of TH x TW pixels of one image, listed map after map, and
// min(tiles, BLOCKS_PER_SM x SMs) persistent blocks walk that list, so that a small map
// (a B=1 scale of 24x32 is one tile) does not leave the card idle. A block stages its tile
// and the halo its terms read (forward rows and columns +2, backward +-2) into shared
// memory once, with 16-byte loads where the column stride is 1 and every row starts on 16
// bytes and scalar loads otherwise, and every term reads shared memory.
// The forward writes each tile's four sums into fixed slots; the last block to finish (a
// __threadfence and an atomic ticket) adds each map's slots in double in a fixed order, so
// the same inputs give the same bits on every run (no float atomics). The ticket is an
// unsigned int per (device, stream) that the wrapper allocates zeroed once
// (ops/_launch.py): it is 0 at every launch, because the last block resets it before it
// exits and launches on one stream run one after another; two streams hold two tickets,
// so they cannot race. The backward, in gather form, recomputes the terms that read each
// pixel and adds ct_k * sgn(term) / (B * count) with weights (1, -2, 1) for dxx and dyy and
// (1, -1, -1, 1) for the mixed terms; sgn(0) = 0, the derivative of |.| in PyTorch.
//
// Bound on an H100 SXM, config 4's group (12 maps, 4.28 M pixels): the forward must read the
// maps once (17.1 MB, 5.1 us at 3.35 TB/s), the backward read them and write the gradients
// (34.3 MB, 10.2 us); ~18 and ~35 operations a pixel take 1.2 and 2.2 us at 67 TFLOP/s.
// Bytes bound both. A tile's halo is read again from L2 by its neighbour, not from memory.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstring>

namespace {

constexpr int THREADS = 256;       // 8 warps
constexpr int TH = 16, TW = 128;   // a tile: TH rows x TW columns of one image
constexpr int MAX_MAPS = 16;
constexpr int BLOCKS_PER_SM = 4;
// the staged box, row pitch BOX_W: forward rows [i0, i0 + TH + 2) and columns
// [j0, j0 + TW + 4); backward rows [i0 - 2, i0 + TH + 2) and columns [j0 - 4, j0 + TW + 4)
// (columns in whole 16-byte words)
constexpr int BOX_H = TH + 4, BOX_W = TW + 8;

// One map of a group, packed by ops/smoothness.py:_MAP.
struct MapDesc {
  const float* x;
  long long sb, sh, sw;  // strides in elements
  long long out_off;     // the map's first pixel in the flat gradient
  int B, H, W;
  int first_tile;        // the map's first tile in the group's list
  int bands, strips;     // tiles of an image: ceil(H / TH) x ceil(W / TW)
  float coef;
  int vec;               // 1: sw == 1 and every row starts on 16 bytes
};
static_assert(sizeof(MapDesc) == 72 && offsetof(MapDesc, B) == 40 &&
              offsetof(MapDesc, coef) == 64, "MapDesc is packed by ops/smoothness.py");

struct Group {
  int n_maps, n_tiles;
  MapDesc maps[MAX_MAPS];
};

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

// Rows [r0, r0 + nr) and columns [c0, c0 + nc) of image b of map m into box (row pitch
// BOX_W), zeros outside the map; c0 and nc are multiples of 4.
__device__ __forceinline__ void stage(const MapDesc& m, int b, int r0, int nr, int c0, int nc,
                                      float* box) {
  const int words = nc / 4;
  const float* img = m.x + b * m.sb;
  for (int e = threadIdx.x; e < nr * words; e += THREADS) {
    const int r = e / words, q = e % words;
    const int i = r0 + r, j = c0 + 4 * q;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i >= 0 && i < m.H) {
      const float* row = img + i * m.sh;
      if (m.vec && j >= 0 && j + 4 <= m.W)
        v = __ldg(reinterpret_cast<const float4*>(row + j));
      else
        v = make_float4(load(row, m.sw, j, m.W), load(row, m.sw, j + 1, m.W),
                        load(row, m.sw, j + 2, m.W), load(row, m.sw, j + 3, m.W));
    }
    *reinterpret_cast<float4*>(box + r * BOX_W + 4 * q) = v;
  }
}

// The staged box, addressed by map coordinates.
struct Box {
  const float* s;
  int i0, j0;  // the map coordinates of s[0]
  __device__ __forceinline__ float at(int i, int j) const {
    return s[(i - i0) * BOX_W + (j - j0)];
  }
};

__device__ __forceinline__ float sgn(float v) {
  return v > 0.f ? 1.f : (v < 0.f ? -1.f : 0.f);
}

// The four terms at a position, each as the plain version forms it.
__device__ __forceinline__ float term_xx(const Box& p, int i, int j) {
  const float dx0 = __fsub_rn(p.at(i, j + 1), p.at(i, j));
  const float dx1 = __fsub_rn(p.at(i, j + 2), p.at(i, j + 1));
  return __fsub_rn(dx1, dx0);
}
__device__ __forceinline__ float term_yy(const Box& p, int i, int j) {
  const float dy0 = __fsub_rn(p.at(i + 1, j), p.at(i, j));
  const float dy1 = __fsub_rn(p.at(i + 2, j), p.at(i + 1, j));
  return __fsub_rn(dy1, dy0);
}
__device__ __forceinline__ float term_xy(const Box& p, int i, int j) {  // dx[i+1]-dx[i]
  const float dx0 = __fsub_rn(p.at(i, j + 1), p.at(i, j));
  const float dx1 = __fsub_rn(p.at(i + 1, j + 1), p.at(i + 1, j));
  return __fsub_rn(dx1, dx0);
}
__device__ __forceinline__ float term_yx(const Box& p, int i, int j) {  // dy[j+1]-dy[j]
  const float dy0 = __fsub_rn(p.at(i + 1, j), p.at(i, j));
  const float dy1 = __fsub_rn(p.at(i + 1, j + 1), p.at(i, j + 1));
  return __fsub_rn(dy1, dy0);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The last block: each map's four sums over its tiles in double (thread t takes tiles t,
// t + THREADS, ...; then the lanes', warps' and terms' sums in a fixed order), term_k =
// sum_t S_t / count_t / B into out[1 + k], and out[0] = sum_k coef_k term_k in map order.
__device__ void finish(const Group& g, const float* slots, float* out) {
  __shared__ double red[THREADS / 32][4];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  double total = 0.0;  // thread 0's
  for (int k = 0; k < g.n_maps; ++k) {
    const MapDesc& m = g.maps[k];
    const int n = m.B * m.bands * m.strips;
    double v[4] = {0.0, 0.0, 0.0, 0.0};
    for (int t = threadIdx.x; t < n; t += THREADS) {
      const float* tile = slots + (long long)(m.first_tile + t) * 4;
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] += (double)__ldcg(tile + q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = warp_sum(v[q]);
      if (lane == 0) red[warp][q] = v[q];
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const double count[4] = {(double)m.H * (m.W - 2), (double)(m.H - 2) * m.W,
                               (double)(m.H - 1) * (m.W - 1), (double)(m.H - 1) * (m.W - 1)};
      double term = 0.0;
      for (int q = 0; q < 4; ++q) {
        double s = 0.0;
        for (int w = 0; w < THREADS / 32; ++w) s += red[w][q];
        term += s / count[q];
      }
      const float tk = (float)(term / m.B);
      out[1 + k] = tk;
      total += (double)m.coef * (double)tk;
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[0] = (float)total;
}

// slots[4 t + q]: tile t's sum of |term q|; out: total, then each map's term; ticket: 0.
__global__ void __launch_bounds__(THREADS)
smooth_group_forward(const __grid_constant__ Group g, float* __restrict__ slots,
                     float* __restrict__ out, unsigned int* __restrict__ ticket) {
  __shared__ __align__(16) float box[BOX_H * BOX_W];
  __shared__ float red[THREADS / 32][4];
  __shared__ bool last;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = locate(g, t);
    const MapDesc& m = g.maps[tl.k];
    stage(m, tl.b, tl.i0, TH + 2, tl.j0, TW + 4, box);
    __syncthreads();
    const Box x{box, tl.i0, tl.j0};
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = warp; r < TH; r += THREADS / 32) {
      const int i = tl.i0 + r;
      for (int c = lane; c < TW; c += 32) {
        const int j = tl.j0 + c;
        if (i >= m.H || j >= m.W) continue;
        if (j + 2 < m.W) s[0] += fabsf(term_xx(x, i, j));
        if (i + 2 < m.H) s[1] += fabsf(term_yy(x, i, j));
        if (i + 1 < m.H && j + 1 < m.W) {
          s[2] += fabsf(term_xy(x, i, j));
          s[3] += fabsf(term_yx(x, i, j));
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float v = warp_sum(s[q]);
      if (lane == 0) red[warp][q] = v;
    }
    __syncthreads();  // also: every read of box is done before the next tile's stage
    if (threadIdx.x < 4) {
      float acc = 0.f;
      for (int w = 0; w < THREADS / 32; ++w) acc += red[w][threadIdx.x];
      slots[(long long)t * 4 + threadIdx.x] = acc;
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

// grad: each map's [B,H,W] gradient, contiguous, from out_off of the flat buffer. ct: the
// cotangent of the total (or null); ct_maps[k * ct_stride]: that of term k (or null).
__global__ void __launch_bounds__(THREADS)
smooth_group_backward(const __grid_constant__ Group g, const float* __restrict__ ct,
                      const float* __restrict__ ct_maps, long long ct_stride,
                      float* __restrict__ grad) {
  __shared__ __align__(16) float box[BOX_H * BOX_W];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int t = blockIdx.x; t < g.n_tiles; t += gridDim.x) {
    const Tile tl = locate(g, t);
    const MapDesc& m = g.maps[tl.k];
    const int B = m.B, H = m.H, W = m.W;
    __syncthreads();  // the previous tile's reads of box are done
    stage(m, tl.b, tl.i0 - 2, TH + 4, tl.j0 - 4, TW + 8, box);
    __syncthreads();
    const Box x{box, tl.i0 - 2, tl.j0 - 4};
    float c = ct != nullptr ? __fmul_rn(*ct, m.coef) : 0.f;
    if (ct_maps != nullptr) c = __fadd_rn(c, ct_maps[tl.k * ct_stride]);
    // d mean / d term = 1 / (B * count), each count converted to float once
    const float g_xx = c / (float)((long long)B * H * (W - 2));
    const float g_yy = c / (float)((long long)B * (H - 2) * W);
    const float g_m = c / (float)((long long)B * (H - 1) * (W - 1));
    float* out = grad + m.out_off + (long long)tl.b * H * W;
    for (int r = warp; r < TH; r += THREADS / 32) {
      const int i = tl.i0 + r;
      for (int cc = lane; cc < TW; cc += 32) {
        const int j = tl.j0 + cc;
        if (i >= H || j >= W) continue;
        // dxx at (i, j - k) reads this pixel with weight (1, -2, 1)[k]; dyy alike along i
        float a_xx = 0.f, a_yy = 0.f, a_xy = 0.f, a_yx = 0.f;
        if (j <= W - 3) a_xx += sgn(term_xx(x, i, j));
        if (j >= 1 && j - 1 <= W - 3) a_xx -= 2.f * sgn(term_xx(x, i, j - 1));
        if (j >= 2) a_xx += sgn(term_xx(x, i, j - 2));
        if (i <= H - 3) a_yy += sgn(term_yy(x, i, j));
        if (i >= 1 && i - 1 <= H - 3) a_yy -= 2.f * sgn(term_yy(x, i - 1, j));
        if (i >= 2) a_yy += sgn(term_yy(x, i - 2, j));
        // a mixed term at (i', j') reads (i', j') +1, (i', j'+1) -1, (i'+1, j') -1,
        // (i'+1, j'+1) +1
        const bool r0 = i <= H - 2, r1 = i >= 1, c0 = j <= W - 2, c1 = j >= 1;
        if (r0 && c0) { a_xy += sgn(term_xy(x, i, j));         a_yx += sgn(term_yx(x, i, j)); }
        if (r0 && c1) { a_xy -= sgn(term_xy(x, i, j - 1));     a_yx -= sgn(term_yx(x, i, j - 1)); }
        if (r1 && c0) { a_xy -= sgn(term_xy(x, i - 1, j));     a_yx -= sgn(term_yx(x, i - 1, j)); }
        if (r1 && c1) { a_xy += sgn(term_xy(x, i - 1, j - 1)); a_yx += sgn(term_yx(x, i - 1, j - 1)); }
        // the a_* are small integers, exact; one rounding per product, then a fixed order
        float v = __fmul_rn(a_xx, g_xx);
        v = __fadd_rn(v, __fmul_rn(a_yy, g_yy));
        v = __fadd_rn(v, __fmul_rn(a_xy, g_m));
        v = __fadd_rn(v, __fmul_rn(a_yx, g_m));
        out[(long long)i * W + j] = v;
      }
    }
  }
}

// The group packed at desc (an (n_maps, n_tiles) int pair, then n_maps MapDescs), or
// false when it holds no map or more than MAX_MAPS.
bool read_group(const void* desc, Group* g) {
  std::memset(g, 0, sizeof(Group));
  std::memcpy(g, desc, offsetof(Group, maps));
  if (g->n_maps < 1 || g->n_maps > MAX_MAPS || g->n_tiles < 1) return false;
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

// The tile (rows, columns) the wrapper cuts the maps into and the most maps a group takes.
void smoothness_layout(int* th, int* tw, int* max_maps) {
  *th = TH;
  *tw = TW;
  *max_maps = MAX_MAPS;
}

// desc: the packed group; slots: 4 floats a tile of scratch; out: 1 + n_maps floats (the
// total, then each map's term); ticket: the stream's zeroed unsigned int. Launches on
// `stream` and returns the cudaError_t of the launch (cudaErrorInvalidValue for a bad group).
int smoothness_group_forward(const void* desc, void* slots, void* out, void* ticket,
                             void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  smooth_group_forward<<<blocks_for(g.n_tiles), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<float*>(slots), static_cast<float*>(out),
      static_cast<unsigned int*>(ticket));
  return static_cast<int>(cudaGetLastError());
}

// desc as above; ct: the total's cotangent, one float on the device, or null;
// ct_maps: the terms' cotangents, n_maps floats ct_stride apart, or null; grad: the flat
// gradient (each map's pixels from its out_off). Launches on `stream`, returns the
// cudaError_t of the launch.
int smoothness_group_backward(const void* desc, const void* ct, const void* ct_maps,
                              long long ct_stride, void* grad, void* stream) {
  Group g;
  if (!read_group(desc, &g)) return static_cast<int>(cudaErrorInvalidValue);
  smooth_group_backward<<<blocks_for(g.n_tiles), THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      g, static_cast<const float*>(ct), static_cast<const float*>(ct_maps), ct_stride,
      static_cast<float*>(grad));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
