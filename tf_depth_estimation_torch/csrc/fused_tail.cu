// Fused DispNet decoder tail for Hopper (sm_90a), f32 on CUDA cores.
//
// Replaces the TPU kernel tf_depth_estimation_tpu/ops/pallas_tail.py:_tail_kernel
// (entry point fused_tail). Given x2 = icnv2's output [B,h,w,32] (f32 or bf16, NHWC)
// and d2 = disp2 [B,h,w,1] f32, it writes d1 [B,2h,2w,1] f32 at full resolution:
//   up  = relu(su * deconv3x3_s2_SAME(x2, w_up) + tu)        upcnv1, 32 -> 16
//   d2u = TF1 bilinear x2 of d2 (rows, then columns; last tap clamped)
//   y   = relu(si * conv3x3_SAME(cat[up, d2u], w_ic) + ti)   icnv1, 17 -> 16
//   d1  = disp_scaling * sigmoid(conv3x3_SAME(y, w_d1) + b_d1) + min_disp
// With bf16 x2, up and d2u are rounded to bf16 at the concat and y before disp1, and
// w_up / w_ic hold bf16-rounded values (ops/fused_tail.py:prepare_tail_params), as in the
// TPU kernel. The BN scale multiplies the f32 accumulator; it is not folded into weights.
//
// Bound on an H100 SXM, per frame at 576x384: upcnv1 0.51 GFLOP (h*w*9*32*16*2), icnv1
// 1.08 GFLOP (H*W*9*17*16*2), disp1 0.06 GFLOP (H*W*9*16*2), 1.66 GFLOP in all; it moves
// 4.65 MB with bf16 x2 (x2 3.54 MB, d2 0.22 MB, d1 0.88 MB) or 8.19 MB with f32 x2. That
// is 1.4 us of HBM time at 3.35 TB/s, 1.7 us of arithmetic at the 989 TFLOP/s bf16
// tensor-core peak and 25 us at the 67 TFLOP/s f32 CUDA-core peak: operations bound it.
// This first design does nothing about that yet: it runs every product in f32 on CUDA
// cores, recomputes the halo rows (1.41x the upcnv1 work, 1.20x icnv1's) and reads the
// weights through L1. Tensor cores (the two convs are GEMMs of K=128 and K=153), TMA and
// bf16 stages come later.
//
// Design: one block of 256 threads per (frame, 16x32 tile of full-resolution outputs).
// Shared memory holds, in f32,
//   s_x   the x2 cells the tile needs (11x19 cells, 33-float stride),
//   s_cat the 17-channel cat over the tile plus a 2-pixel halo (20x36, stride 17),
//   s_y   icnv1's output over the tile plus a 1-pixel halo (18x34, stride 17),
// s_y reusing s_x's space once the cat is built: 90,576 bytes of dynamic shared memory,
// two blocks per SM. Values outside the image are zeros, as TF SAME pads.
// upcnv1 runs per 2x2 cell of full-resolution pixels: the cell at x2 position (U, V)
// reads x2 cells (U-1..U, V-1..V), and each of the 9 kernel taps feeds exactly one of its
// four pixels, so a thread keeps 4x16 accumulators and every weight it reads is the same
// across the warp (a broadcast).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CI = 32;  // x2 channels
constexpr int CU = 16;  // upcnv1 outputs
constexpr int CC = 17;  // cat channels: up (16) + d2u (1)
constexpr int CY = 16;  // icnv1 outputs
constexpr int TH = 16, TW = 32;                   // full-resolution output tile
constexpr int CAT_H = TH + 4, CAT_W = TW + 4;     // cat rows r0-2 .. r0+TH+1
constexpr int CELL_H = CAT_H / 2, CELL_W = CAT_W / 2;
constexpr int Y_H = TH + 2, Y_W = TW + 2;         // y rows r0-1 .. r0+TH
constexpr int XC_H = CELL_H + 1, XC_W = CELL_W + 1;  // x2 cells r0/2-2 .. r0/2+TH/2
constexpr int XS = CI + 1;  // padded strides: consecutive threads hit distinct banks
constexpr int CS = CC;
constexpr int YS = CY + 1;
constexpr int THREADS = 256;

// packed parameter buffer (float32), see ops/fused_tail.py:prepare_tail_params
constexpr int OFF_WUP = 0;                       // [3][3][32][16]  (a, b, ci, co)
constexpr int OFF_WIC = OFF_WUP + 9 * CI * CU;   // [3][3][17][16]  (a, b, c, co)
constexpr int OFF_WD1 = OFF_WIC + 9 * CC * CY;   // [3][3][16]
constexpr int OFF_AFF = OFF_WD1 + 9 * CY;        // su, tu, si, ti: 16 each
constexpr int OFF_BD1 = OFF_AFF + 4 * 16;
constexpr int N_PARAMS = OFF_BD1 + 1;

constexpr int SMEM_CAT = CAT_H * CAT_W * CS;
constexpr int SMEM_X = XC_H * XC_W * XS;
constexpr int SMEM_Y = Y_H * Y_W * YS;
constexpr int SMEM_UNION = SMEM_X > SMEM_Y ? SMEM_X : SMEM_Y;
constexpr size_t SMEM_BYTES = sizeof(float) * (SMEM_CAT + SMEM_UNION);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <bool BF16>
__device__ __forceinline__ float stage_round(float v) {
  return BF16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// acc[0..15] += v * w[0..15], w 16-byte aligned and uniform across the warp
__device__ __forceinline__ void fma16(float* acc, float v, const float* w) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 q = __ldg(w4 + k);
    acc[4 * k + 0] = fmaf(v, q.x, acc[4 * k + 0]);
    acc[4 * k + 1] = fmaf(v, q.y, acc[4 * k + 1]);
    acc[4 * k + 2] = fmaf(v, q.z, acc[4 * k + 2]);
    acc[4 * k + 3] = fmaf(v, q.w, acc[4 * k + 3]);
  }
}

template <typename T, bool BF16>
__global__ void __launch_bounds__(THREADS)
fused_tail_kernel(const T* __restrict__ x2, const float* __restrict__ d2,
                  const float* __restrict__ prm, float* __restrict__ out,
                  int h, int w, float disp_scaling, float min_disp) {
  extern __shared__ float smem[];
  float* s_cat = smem;
  float* s_x = smem + SMEM_CAT;
  float* s_y = s_x;  // reused once the cat is built

  const int H = 2 * h, W = 2 * w;
  const int b = blockIdx.z;
  const int r0 = blockIdx.y * TH, c0 = blockIdx.x * TW;
  const int u0 = r0 / 2 - 2, v0 = c0 / 2 - 2;  // first staged x2 cell
  const int tid = threadIdx.x;
  const T* xb = x2 + (size_t)b * h * w * CI;
  const float* db = d2 + (size_t)b * h * w;

  // 1. stage the x2 cells, zero outside the image
  for (int i = tid; i < XC_H * XC_W * CI; i += THREADS) {
    const int c = i % CI, cell = i / CI;
    const int u = u0 + cell / XC_W, v = v0 + cell % XC_W;
    float val = 0.f;
    if (u >= 0 && u < h && v >= 0 && v < w) val = to_f32(xb[((size_t)u * w + v) * CI + c]);
    s_x[cell * XS + c] = val;
  }
  __syncthreads();

  // 2. upcnv1 + BN + ReLU and the d2 upsample, per 2x2 cell of the cat tile.
  // Cat index (i, j) is pixel (r0-2+i, c0-2+j); cell (ci, cj) sits at x2 cell
  // (U, V) = (r0/2-1+ci, c0/2-1+cj), whose taps read staged cells ci..ci+1, cj..cj+1.
  const float* w_up = prm + OFF_WUP;
  const float* aff = prm + OFF_AFF;
  for (int cell = tid; cell < CELL_H * CELL_W; cell += THREADS) {
    const int ci = cell / CELL_W, cj = cell % CELL_W;
    float acc[4][CU];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int o = 0; o < CU; ++o) acc[p][o] = 0.f;
    const float* x00 = s_x + (ci * XC_W + cj) * XS;  // cell (U-1, V-1)
    const float* x01 = x00 + XS;                      // (U-1, V)
    const float* x10 = x00 + XC_W * XS;               // (U, V-1)
    const float* x11 = x10 + XS;                      // (U, V)
    for (int c = 0; c < CI; ++c) {
      const float* wc = w_up + c * CU;  // + (a*3+b)*CI*CU selects tap (a, b)
      const float a00 = x00[c], a01 = x01[c], a10 = x10[c], a11 = x11[c];
      // pixel (2U+p, 2V+q) gathers x2 cell (i, j) through tap (2U+p-2i, 2V+q-2j)
      fma16(acc[0], a11, wc + 0 * CI * CU);  // (0,0) <- (U,V)     tap (0,0)
      fma16(acc[0], a10, wc + 2 * CI * CU);  // (0,0) <- (U,V-1)   tap (0,2)
      fma16(acc[0], a01, wc + 6 * CI * CU);  // (0,0) <- (U-1,V)   tap (2,0)
      fma16(acc[0], a00, wc + 8 * CI * CU);  // (0,0) <- (U-1,V-1) tap (2,2)
      fma16(acc[1], a11, wc + 1 * CI * CU);  // (0,1) <- (U,V)     tap (0,1)
      fma16(acc[1], a01, wc + 7 * CI * CU);  // (0,1) <- (U-1,V)   tap (2,1)
      fma16(acc[2], a11, wc + 3 * CI * CU);  // (1,0) <- (U,V)     tap (1,0)
      fma16(acc[2], a10, wc + 5 * CI * CU);  // (1,0) <- (U,V-1)   tap (1,2)
      fma16(acc[3], a11, wc + 4 * CI * CU);  // (1,1) <- (U,V)     tap (1,1)
    }
    const int U = r0 / 2 - 1 + ci, V = c0 / 2 - 1 + cj;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int R = 2 * U + p, C = 2 * V + q;
        float* dst = s_cat + ((2 * ci + p) * CAT_W + (2 * cj + q)) * CS;
        if (R < 0 || R >= H || C < 0 || C >= W) {
#pragma unroll
          for (int o = 0; o < CC; ++o) dst[o] = 0.f;
          continue;
        }
#pragma unroll
        for (int o = 0; o < CU; ++o)
          dst[o] = stage_round<BF16>(fmaxf(acc[2 * p + q][o] * __ldg(aff + o) +
                                               __ldg(aff + 16 + o), 0.f));
        // TF1 bilinear x2: rows first, then columns, last tap clamped
        const int U1 = min(U + 1, h - 1), V1 = min(V + 1, w - 1);
        float t0 = __ldg(db + (size_t)U * w + V), t1 = __ldg(db + (size_t)U * w + V1);
        if (p) {
          t0 = 0.5f * (t0 + __ldg(db + (size_t)U1 * w + V));
          t1 = 0.5f * (t1 + __ldg(db + (size_t)U1 * w + V1));
        }
        dst[CU] = stage_round<BF16>(q ? 0.5f * (t0 + t1) : t0);
      }
    }
  }
  __syncthreads();

  // 3. icnv1 + BN + ReLU over the tile plus a 1-pixel halo; y index (i, j) is pixel
  // (r0-1+i, c0-1+j) and reads cat indices (i+a, j+b).
  const float* w_ic = prm + OFF_WIC;
  for (int pix = tid; pix < Y_H * Y_W; pix += THREADS) {
    const int yi = pix / Y_W, yj = pix % Y_W;
    float acc[CY];
#pragma unroll
    for (int o = 0; o < CY; ++o) acc[o] = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const float* src = s_cat + ((yi + a) * CAT_W + (yj + bb)) * CS;
        const float* wt = w_ic + (a * 3 + bb) * CC * CY;
        for (int c = 0; c < CC; ++c) fma16(acc, src[c], wt + c * CY);
      }
    }
    const int R = r0 - 1 + yi, C = c0 - 1 + yj;
    const bool inside = R >= 0 && R < H && C >= 0 && C < W;
    float* dst = s_y + pix * YS;
#pragma unroll
    for (int o = 0; o < CY; ++o)
      dst[o] = inside ? stage_round<BF16>(fmaxf(acc[o] * __ldg(aff + 32 + o) +
                                                    __ldg(aff + 48 + o), 0.f))
                      : 0.f;
  }
  __syncthreads();

  // 4. disp1 + bias + scaled sigmoid on the tile
  const float* w_d1 = prm + OFF_WD1;
  const float bias = __ldg(prm + OFF_BD1);
  for (int pix = tid; pix < TH * TW; pix += THREADS) {
    const int oi = pix / TW, oj = pix % TW;
    const int R = r0 + oi, C = c0 + oj;
    if (R >= H || C >= W) continue;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
      for (int bb = 0; bb < 3; ++bb) {
        const float* src = s_y + ((oi + a) * Y_W + (oj + bb)) * YS;
        const float* wt = w_d1 + (a * 3 + bb) * CY;
#pragma unroll
        for (int c = 0; c < CY; ++c) acc = fmaf(src[c], __ldg(wt + c), acc);
      }
    }
    const float z = acc + bias;
    out[((size_t)b * H + R) * W + C] = disp_scaling / (1.f + expf(-z)) + min_disp;
  }
}

template <typename T, bool BF16>
cudaError_t launch(const void* x2, const void* d2, const void* prm, void* out, int B,
                   int h, int w, float disp_scaling, float min_disp, cudaStream_t stream) {
  auto kernel = fused_tail_kernel<T, BF16>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((2 * w + TW - 1) / TW, (2 * h + TH - 1) / TH, B);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const T*>(x2), static_cast<const float*>(d2),
      static_cast<const float*>(prm), static_cast<float*>(out), h, w, disp_scaling,
      min_disp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int fused_tail_num_params() { return N_PARAMS; }

// x2 [B,h,w,32] (bf16 if x2_is_bf16, else f32), d2 [B,h,w] f32, params: N_PARAMS f32,
// out [B,2h,2w] f32; all contiguous on the current device. Returns a cudaError_t.
extern "C" int fused_tail_launch(const void* x2, const void* d2, const void* params,
                                 void* out, int B, int h, int w, int x2_is_bf16,
                                 float disp_scaling, float min_disp, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x2_is_bf16
          ? launch<__nv_bfloat16, true>(x2, d2, params, out, B, h, w, disp_scaling, min_disp, s)
          : launch<float, false>(x2, d2, params, out, B, h, w, disp_scaling, min_disp, s);
  return static_cast<int>(err);
}
