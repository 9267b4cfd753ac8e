// Fused DispNet decoder tail for Hopper (sm_90a): bf16 on the tensor cores (wgmma fed by
// TMA), float32 on the CUDA cores.
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
//
// bf16 (tc::tail_bf16_kernel): upcnv1 and icnv1 run on the tensor cores, disp1 (N = 1)
// on the CUDA cores in f32. Persistent blocks of two warpgroups, three a SM (72 KB of
// shared memory each; chip_smoke.py prints the registers), walk items of (frame, segment of x2 rows, strip of
// at most 124 output columns) as a rolling window: each step takes one x2 row U and makes
// cat rows 2U, 2U + 1, y rows 2U - 1, 2U and d1 rows 2U - 2, 2U - 1, the cat and y rows
// kept in rings of 4 in shared memory, so only a strip's 2-pixel sides and a segment's
// first 2 steps are computed twice. x2 rows arrive by TMA (a 4-D map over [B, h, w, 32],
// whose zero fill past every edge is TF SAME's padding) into a ring of 4 slots, 3 rows
// ahead of the math, in the 64-byte swizzle. The weights stay in shared memory for the
// block's life, bf16 in the 128-byte swizzle (K-major). Both convolutions read A straight
// from shared memory through wgmma descriptors, with no im2col copy and no registers: the
// swizzle is a function of the address, so a descriptor whose start moves by whole rows
// reads a shifted window (the x2 slots are a K-major layout in the 64-byte swizzle with
// 64-byte rows, the cat rows one in the 32-byte swizzle with 32-byte rows).
//   * upcnv1 is the phase GEMM of pallas_tail.py:61-64 (K_up): M = 64 cells of a cat row,
//     K = 128 = (cy, cx, ci) over the cells (U - 1 + cy, V - 1 + cx), N = 64 = (p, q, o).
//     Warpgroup p computes phase row p (m64n32k16, 8 k-steps; p = 1 needs only the 4 of
//     x2 row U); a cell shift is a descriptor 64 bytes on.
//   * icnv1 per full-resolution pixel: M = 64 pixels of a y row, N = 16, K = 160: each of
//     the 9 taps one k16 step of 16 up channels at the tap's shifted pixel, and one step
//     of the 9 d2u taps and 7 zeros built in registers (6 % of K is padding, where JAX's
//     overlapped 4x4/s2 form of pallas_tail.py:66-82 pads 44 %).
//   * the epilogues scale by the BN, add its shift, ReLU, round to bf16 and write the cat
//     and y rows; outside the image they write zeros, TF SAME's padding of the next conv.
//   * disp1: a thread takes both d1 rows of a step at one column, so that each y pixel it
//     loads feeds two outputs; its f32 weights are kernel arguments (the constant bank).
// Per 576-column row, 5 strips of 116 columns compute 128 cat and 128 y columns each
// (1.10x), and each segment of seg x2 rows pays 2 more steps; at B=64 the plan picks seg =
// 32 (1.06x upcnv1, 1.03x icnv1). What holds a launch back is in PERF.md
// (tools/tail_variants.py): the shared-memory reads of the 9-tap im2col through the
// descriptors, disp1's f32 multiply-adds and the two block barriers of each step.
//
// float32 (fused_tail_kernel): one block of 256 threads per (frame, 16x32 tile of
// full-resolution outputs), every product in f32 on CUDA cores, the halo rows recomputed
// (1.41x the upcnv1 work, 1.20x icnv1's) and the weights read through L1; it serves the
// float32 parity checks.
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

#include <algorithm>

#include "hopper.cuh"

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

__global__ void __launch_bounds__(THREADS)
fused_tail_kernel(const float* __restrict__ x2, const float* __restrict__ d2,
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
  const float* xb = x2 + (size_t)b * h * w * CI;
  const float* db = d2 + (size_t)b * h * w;

  // 1. stage the x2 cells, zero outside the image
  for (int i = tid; i < XC_H * XC_W * CI; i += THREADS) {
    const int c = i % CI, cell = i / CI;
    const int u = u0 + cell / XC_W, v = v0 + cell % XC_W;
    float val = 0.f;
    if (u >= 0 && u < h && v >= 0 && v < w) val = xb[((size_t)u * w + v) * CI + c];
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
          dst[o] = fmaxf(acc[2 * p + q][o] * __ldg(aff + o) + __ldg(aff + 16 + o), 0.f);
        // TF1 bilinear x2: rows first, then columns, last tap clamped
        const int U1 = min(U + 1, h - 1), V1 = min(V + 1, w - 1);
        float t0 = __ldg(db + (size_t)U * w + V), t1 = __ldg(db + (size_t)U * w + V1);
        if (p) {
          t0 = 0.5f * (t0 + __ldg(db + (size_t)U1 * w + V));
          t1 = 0.5f * (t1 + __ldg(db + (size_t)U1 * w + V1));
        }
        dst[CU] = q ? 0.5f * (t0 + t1) : t0;
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
      dst[o] = inside ? fmaxf(acc[o] * __ldg(aff + 32 + o) + __ldg(aff + 48 + o), 0.f) : 0.f;
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

cudaError_t launch_f32(const void* x2, const void* d2, const void* prm, void* out, int B,
                       int h, int w, float disp_scaling, float min_disp, cudaStream_t stream) {
  auto kernel = fused_tail_kernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
  if (err != cudaSuccess) return err;
  const dim3 grid((2 * w + TW - 1) / TW, (2 * h + TH - 1) / TH, B);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      static_cast<const float*>(x2), static_cast<const float*>(d2),
      static_cast<const float*>(prm), static_cast<float*>(out), h, w, disp_scaling,
      min_disp);
  return cudaGetLastError();
}


// ---- bf16: upcnv1 and icnv1 on the tensor cores ------------------------------------

namespace tc {

using namespace hopper;

constexpr int THREADS = 256;        // two warpgroups: each takes one of the two rows of a step
constexpr int MAX_TW = 124;         // output columns a strip holds at most: 126 y, 128 cat
constexpr int CELLS = 64;           // upcnv1's M: the x2 cells of a cat row (128 pixels)
constexpr int XCELLS = CELLS + 1;   // the x2 cells a row's TMA box holds
constexpr int XBYTES = XCELLS * CI * 2;
constexpr int XSLOT = 4608;         // a ring slot: XBYTES rounded up to the 64B swizzle's 512
constexpr int NX = 4;               // x2 rows in their ring
constexpr int NR = 4;               // cat rows and y rows in theirs
constexpr int CAT_PX = 136;         // pixels a cat row: 128, and the taps of y pixels past 126
constexpr int Y_PX = 128;           // pixels a y row
constexpr int KIC = 160;            // icnv1's K: 9 taps x 16 up channels, 9 d2u taps, 7 zeros
constexpr int KIC_STEPS = KIC / 16;
// the operands' offsets in the packed buffer, after the f32 kernel's parameters
constexpr int OFF_KUP = N_PARAMS;                  // [64 (p, q, o)][128 (cy, cx, ci)]
constexpr int OFF_KIC = OFF_KUP + 4 * CU * 4 * CI;  // [16 o][160]
constexpr int N_ALL = OFF_KIC + CY * KIC;
// shared memory (bytes from a 1024-aligned base)
constexpr int S_KUP = 0;                        // [3 (p, K block)][32 rows][128 B], 128B swizzle
constexpr int S_KIC = S_KUP + 3 * 32 * 128;      // [3 K blocks][16 rows][128 B], 128B swizzle
constexpr int S_X = S_KIC + 3 * 16 * 128;        // NX slots of XCELLS x 64 B, 64B swizzle
constexpr int S_CAT = S_X + NX * XSLOT;          // NR rows of CAT_PX x 16 bf16 (up)
constexpr int S_Y = S_CAT + NR * CAT_PX * 32;    // NR rows of Y_PX x 16 bf16
constexpr int S_D2U = S_Y + NR * Y_PX * 32;      // NR rows of CAT_PX bf16
constexpr int S_BAR = S_D2U + NR * CAT_PX * 2;   // NX mbarriers
constexpr int SMEM = S_BAR + NX * 8 + 1024;      // and the base's alignment
static_assert(S_KIC % 1024 == 0 && S_X % 512 == 0 && XSLOT % 512 == 0 && XBYTES <= XSLOT &&
                  S_CAT % 256 == 0 && (CAT_PX * 32) % 256 == 0,
              "the swizzled operands are aligned to their swizzle's repeat");
static_assert(S_BAR % 8 == 0, "alignment");

// What a launch walks: items of (frame, segment of `seg` x2 rows, strip of `tw` output
// columns), each a rolling window down its strip, the blocks taking items in turn.
struct Plan {
  int h, w, H, W;
  int tw, strips;     // output columns a strip (even), strips a frame
  int seg, segs;      // x2 rows a segment, segments a frame
  int items;          // B * segs * strips
  float disp_scaling, min_disp;
};

// disp1's weights, (a, b, c), and bias, passed by value: a kernel argument lives in the
// constant bank, so the f32 multiply-adds of step C read each weight as an operand, with no
// load and no shared-memory traffic
struct Disp1 {
  float w[9 * CY];
  float bias;
};

__device__ __forceinline__ void item_coords(const Plan& t, int item, int& b, int& c0, int& U0) {
  const int r = item / t.strips;
  c0 = (item % t.strips) * t.tw;
  U0 = (r % t.segs) * t.seg;
  b = r / t.segs;
}

// D[64, 16] (+)= A[64, 16] . B[16, 16] for one warpgroup: A from registers (the mma.sync
// A fragment of each warp's 16 rows), B K-major from shared memory through its descriptor
__device__ __forceinline__ void mma_n16(float* d, const uint32_t* a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// D[64, N] (+)= A[64, 16] . B[16, N], A and B K-major from shared memory through their
// descriptors. A is read in place: the x2 slots (64-byte cell rows in the 64-byte swizzle,
// layout 2, 8-row groups 512 bytes apart) and the cat rows (32-byte pixel rows in the
// 32-byte swizzle, layout 3, 256 bytes apart), from the shifted cell or pixel on.
__device__ __forceinline__ void mma_n32_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d));
}
__device__ __forceinline__ void mma_n16_ss(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7])
      : "l"(a), "l"(b), "r"(scale_d));
}

// byte offset of 16-value pixel `px` of a cat or y row, half `half` (8 values): the halves
// of pixels 4-7 of each 8 swap (the 32-byte swizzle, rows 256-byte aligned), so that 8
// neighbouring pixels' halves fill all 32 banks
__device__ __forceinline__ int px_off(int px, int half) {
  return px * 32 + ((half ^ ((px >> 2) & 1)) << 4);
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// Step A, warpgroup P: cat row R = 2U + P, its 16 up channels on the tensor cores. The 64
// cells V = c0/2 - 1 + j (j < 64) are the rows of A; K is (cy, cx, ci): x2 cell (U - 1 +
// cy, V - 1 + cx), channel ci, read by the descriptor straight from the TMA's slots
// (x_prev: x2 row U - 1, x_cur: row U; from cell cx of the box on). N is (q, o):
// phase (P, q) of the cell, pixel (R, 2V + q), channel o. Row U - 1 feeds only phase p = 0
// (its taps a = p + 2 exist for p = 0 alone), so P = 1 runs K's second half.
template <int P>
__device__ __forceinline__ void upcnv1(uint32_t sb, uint8_t* cat, uint32_t x_prev,
                                       uint32_t x_cur, int R, int c0, int H, int W, int row0,
                                       int c, const float* su, const float* tu) {
  constexpr int S0 = P ? 4 : 0;
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int s = S0; s < 8; ++s) {
    const int cy = s >> 2, cx = (s >> 1) & 1;
    mma_n32_ss(acc, desc((cy ? x_cur : x_prev) + cx * 64 + (s & 1) * 32, 16, 512, 2),
               desc(sb + S_KUP + (P + (s >> 2)) * 4096 + 32 * (s & 3), 16, 1024), s > S0);
  }
  wgmma_commit();
  wgmma_wait<0>();
  // accumulator d[4j + 2i + k]: cell row0 + 8i, column 8j + 2c + k = (q = j / 2, o)
  const bool row_in = R >= 0 && R < H;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int half = j & 1, px = 2 * (row0 + 8 * i) + (j >> 1), C = c0 - 2 + px;
      __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
      if (row_in && C >= 0 && C < W)
        v = __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * i] * su[2 * half] + tu[2 * half], 0.f),
                                  fmaxf(acc[4 * j + 2 * i + 1] * su[2 * half + 1] +
                                            tu[2 * half + 1], 0.f));
      *reinterpret_cast<__nv_bfloat162*>(cat + px_off(px, half) + 4 * c) = v;
    }
  }
}

// Step B, one warpgroup: y row Ry over 128 pixels (two M blocks of 64), y pixel i at
// column c0 - 1 + i. K is 9 taps (a, b) x 16 up channels, each tap one k16 step read by
// its descriptor from cat row Ry - 1 + a, pixel i + b on; then one step of the 9 d2u taps
// and 7 zeros, built in registers from the d2u rows.
__device__ __forceinline__ void icnv1(uint32_t sb, uint8_t* smem, int Ry, int c0, int H, int W,
                                      int row0, int c, const float* si, const float* ti) {
  uint8_t* ydst = smem + S_Y + (Ry & (NR - 1)) * Y_PX * 32;
  const __nv_bfloat16* d2u = reinterpret_cast<const __nv_bfloat16*>(smem + S_D2U);
  const bool row_in = Ry >= 0 && Ry < H;
#pragma unroll 1
  for (int mb = 0; mb < 2; ++mb) {
    // the d2u step's A: register r holds K (2c, 2c + 1) (r = 0, 1) or (2c + 8, 2c + 9)
    // (r = 2, 3) of row row0 (r even) or row0 + 8 (r odd); K = tap, zero past 8
    uint32_t a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int k0 = 2 * c + 8 * (r >> 1), row = 64 * mb + row0 + 8 * (r & 1);
      uint32_t v = 0;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + e;
        if (k < 9)
          v |= bf16_bits(d2u + ((Ry - 1 + k / 3) & (NR - 1)) * CAT_PX + row + k % 3) << (16 * e);
      }
      a[r] = v;
    }
    float acc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 9; ++s)
      mma_n16_ss(acc, desc(sb + S_CAT + ((Ry - 1 + s / 3) & (NR - 1)) * CAT_PX * 32 +
                               (64 * mb + s % 3) * 32, 16, 256, 3),
                 desc(sb + S_KIC + (s >> 2) * 2048 + 32 * (s & 3), 16, 1024), s > 0);
    mma_n16(acc, a,
            desc(sb + S_KIC + ((KIC_STEPS - 1) >> 2) * 2048 + 32 * ((KIC_STEPS - 1) & 3), 16,
                 1024), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int px = 64 * mb + row0 + 8 * i, C = c0 - 1 + px;
      const bool in = row_in && C >= 0 && C < W;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        __nv_bfloat162 v = __floats2bfloat162_rn(0.f, 0.f);
        if (in)
          v = __floats2bfloat162_rn(fmaxf(acc[4 * j + 2 * i] * si[2 * j] + ti[2 * j], 0.f),
                                    fmaxf(acc[4 * j + 2 * i + 1] * si[2 * j + 1] +
                                              ti[2 * j + 1], 0.f));
        *reinterpret_cast<__nv_bfloat162*>(ydst + px_off(px, j) + 4 * c) = v;
      }
    }
  }
}

// Step C: d1 rows Rd and Rd + 1 at output column o, disp1 in f32 on the CUDA cores. Each
// y pixel of rows Rd - 1 .. Rd + 2, columns o .. o + 2 (y pixel i at column c0 - 1 + i) is
// loaded once and feeds both rows; four partial sums a row.
__device__ __forceinline__ void disp1_pair(const uint8_t* smem, const Disp1& hd, float* ob,
                                           int Rd, int c0, int o, const Plan& t) {
  float acc[2][4] = {};
#pragma unroll
  for (int bb = 0; bb < 3; ++bb) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const uint8_t* y = smem + S_Y + ((Rd - 1 + r) & (NR - 1)) * Y_PX * 32;
      const uint4 lo = *reinterpret_cast<const uint4*>(y + px_off(o + bb, 0));
      const uint4 hi = *reinterpret_cast<const uint4*>(y + px_off(o + bb, 1));
      const uint32_t u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int ch = 0; ch < CY; ++ch) {
        const float v = __uint_as_float(ch & 1 ? u[ch >> 1] & 0xffff0000u : u[ch >> 1] << 16);
        if (r < 3) acc[0][ch & 3] = fmaf(v, hd.w[(3 * r + bb) * CY + ch], acc[0][ch & 3]);
        if (r > 0) acc[1][ch & 3] = fmaf(v, hd.w[(3 * (r - 1) + bb) * CY + ch], acc[1][ch & 3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (Rd + i >= t.H) break;
    const float z = (acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3]) + hd.bias;
    ob[static_cast<size_t>(Rd + i) * t.W + c0 + o] =
        t.disp_scaling / (1.f + expf(-z)) + t.min_disp;
  }
}

__global__ void __launch_bounds__(THREADS, 3)
tail_bf16_kernel(const __grid_constant__ CUtensorMap map_x, const float* __restrict__ d2,
                 const float* __restrict__ prm, float* __restrict__ out, const Plan t,
                 const Disp1 hd) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_addr(smem);
  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, warp = wt >> 5, lane = tid & 31;
  const int lpi = t.seg + 3;  // x2 rows an item loads: U0 - 2 .. U0 + seg
  auto bar = [&](int T) { return sb + S_BAR + 8 * (T % NX); };
  auto slot = [&](int T) { return sb + S_X + (T % NX) * XSLOT; };
  auto parity = [&](int T) { return static_cast<uint32_t>((T / NX) & 1); };

  // Thread PRODUCER asks the TMA for x2 rows: load T of the block is row j = T % lpi of its
  // item T / lpi, into slot T % NX. It asks up to `limit`, so NX - 1 rows run ahead of the
  // rows in use, across the end of an item. Its warp has no disp1 column in step C, where
  // it asks, so the asking delays no product.
  constexpr int PRODUCER = 128;
  int asked = 0;
  auto ask = [&](int limit) {
    for (; asked < limit; ++asked) {
      const int item = blockIdx.x + (asked / lpi) * gridDim.x;
      if (item >= t.items) return;
      int b, c0, U0;
      item_coords(t, item, b, c0, U0);
      mbar_expect_tx(bar(asked), XBYTES);
      tma_load_4d(slot(asked), &map_x, bar(asked), 0, c0 / 2 - 2, U0 - 2 + asked % lpi, b);
    }
  };
  if (tid == PRODUCER) {
    for (int s = 0; s < NX; ++s) mbar_init(sb + S_BAR + 8 * s, 1);
    fence_mbar_init();
    ask(NX);
  }

  // the operands, once a block: bf16 in the 128-byte swizzle that the descriptors read
  // upcnv1's: block (p, K half) at (p + K half) * 4096; p = 1's first K half (x2 row U - 1)
  // is zero and not kept
  for (int i = tid; i < 4 * CU * 4 * CI; i += THREADS) {
    const int n = i >> 7, k = i & 127, r = n & 31, kk = k & 63, blk = (n >> 5) + (k >> 6);
    if ((n >> 5) && !(k >> 6)) continue;
    const int off = blk * 4096 + r * 128 + (((kk >> 3) ^ (r & 7)) << 4) + (kk & 7) * 2;
    *reinterpret_cast<__nv_bfloat16*>(smem + S_KUP + off) =
        __float2bfloat16_rn(__ldg(prm + OFF_KUP + i));
  }
  for (int i = tid; i < CY * 192; i += THREADS) {
    const int n = i / 192, k = i % 192, kk = k & 63;
    const float v = k < KIC ? __ldg(prm + OFF_KIC + n * KIC + k) : 0.f;
    const int off = (k >> 6) * 2048 + n * 128 + (((kk >> 3) ^ (n & 7)) << 4) + (kk & 7) * 2;
    *reinterpret_cast<__nv_bfloat16*>(smem + S_KIC + off) = __float2bfloat16_rn(v);
  }
  // this thread's four accumulator channels, o = 8 half + 2c + k, for both epilogues
  const int g = lane >> 2, c = lane & 3, row0 = 16 * warp + g;
  float su[4], tu[4], si[4], ti[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int o = 8 * (e >> 1) + 2 * c + (e & 1);
    su[e] = __ldg(prm + OFF_AFF + o);
    tu[e] = __ldg(prm + OFF_AFF + 16 + o);
    si[e] = __ldg(prm + OFF_AFF + 32 + o);
    ti[e] = __ldg(prm + OFF_AFF + 48 + o);
  }
  fence_async_smem();  // the operands are read by wgmma
  __syncthreads();

  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  // the d2 values of this thread's d2u pixel wt of cat row 2U + wg: V and V + 1 of d2 row
  // U, and (wg = 1) of row U + 1, the last ones clamped; false outside the image
  float d2v[4] = {0.f, 0.f, 0.f, 0.f};
  auto load_d2 = [&](const float* db, int U, int c0) {
    const int R = 2 * U + wg, C = c0 - 2 + wt;
    if (R < 0 || R >= t.H || C < 0 || C >= t.W) return false;
    const int V = C >> 1, U1 = min(U + 1, t.h - 1), V1 = min(V + 1, t.w - 1);
    d2v[0] = __ldg(db + U * t.w + V);
    d2v[1] = __ldg(db + U * t.w + V1);
    if (wg) {
      d2v[2] = __ldg(db + U1 * t.w + V);
      d2v[3] = __ldg(db + U1 * t.w + V1);
    }
    return true;
  };
  int n_local = 0;
  for (int item = blockIdx.x; item < t.items; item += gridDim.x, ++n_local) {
    int b, c0, U0;
    item_coords(t, item, b, c0, U0);
    const int T0 = n_local * lpi;
    const float* db = d2 + static_cast<size_t>(b) * t.h * t.w;
    float* ob = out + static_cast<size_t>(b) * t.H * t.W;
    bool d2u_in = load_d2(db, U0 - 1, c0);
    // step k: cat rows 2U, 2U + 1 (U = U0 - 1 + k), y rows 2U - 1, 2U, d1 rows 2U - 2,
    // 2U - 1; the first two steps fill the rings, the d1 rows of the item are 2 U0 ..
    for (int k = 0; k <= t.seg + 1; ++k) {
      const int U = U0 - 1 + k, R = 2 * U + wg;
      // A. cat row R: up on the tensor cores (x2 rows U - 1 and U), d2u on the CUDA cores
      // (TF1 bilinear x2: rows first, then columns, last tap clamped) from the d2 values
      // loaded a step ahead
      mbar_wait(bar(T0 + k + 1), parity(T0 + k + 1));
      uint8_t* cat = smem + S_CAT + (R & (NR - 1)) * CAT_PX * 32;
      if (wg == 0) {
        mbar_wait(bar(T0 + k), parity(T0 + k));
        upcnv1<0>(sb, cat, slot(T0 + k), slot(T0 + k + 1), R, c0, t.H, t.W, row0, c, su, tu);
      } else {
        upcnv1<1>(sb, cat, slot(T0 + k), slot(T0 + k + 1), R, c0, t.H, t.W, row0, c, su, tu);
      }
      {
        float t0 = d2v[0], t1 = d2v[1];
        if (wg) {
          t0 = 0.5f * (t0 + d2v[2]);
          t1 = 0.5f * (t1 + d2v[3]);
        }
        reinterpret_cast<__nv_bfloat16*>(smem + S_D2U)[(R & (NR - 1)) * CAT_PX + wt] =
            d2u_in ? __float2bfloat16_rn(((c0 + wt) & 1) ? 0.5f * (t0 + t1) : t0) : zero;
      }
      if (k <= t.seg) d2u_in = load_d2(db, U + 1, c0);  // the next step's, a step ahead
      fence_async_smem();  // step B's wgmma read the cat rows through the async proxy
      __syncthreads();
      // B. y row 2U - 1 + wg
      if (k >= 1) icnv1(sb, smem, 2 * U - 1 + wg, c0, t.H, t.W, row0, c, si, ti);
      __syncthreads();
      if (tid == PRODUCER) ask(T0 + k + 1 + NX);  // x2 row U - 1 is free
      // C. d1 rows 2U - 2 and 2U - 1 at output column o: warps 0-1 of warpgroup 0 take
      // columns 0-61, warps 2-3 of warpgroup 1 columns 62-123, one warp on each SM
      // sub-partition
      const int o = wg ? wt - 64 + MAX_TW / 2 : wt;
      if (k >= 2 && (wg ? wt >= 64 && wt < 64 + MAX_TW / 2 : wt < MAX_TW / 2) && o < t.tw &&
          c0 + o < t.W)
        disp1_pair(smem, hd, ob, 2 * U - 2, c0, o, t);
    }
  }
}

// The plan: strips of at most MAX_TW output columns, balanced; then the segment length
// whose items, dealt to as many blocks as fit on the card at once, take the fewest steps
// on the busiest block (each item pays 2 steps to fill its rings).
inline Plan plan(int B, int h, int w, int slots, float disp_scaling, float min_disp) {
  Plan t;
  t.h = h, t.w = w, t.H = 2 * h, t.W = 2 * w;
  t.strips = (t.W + MAX_TW - 1) / MAX_TW;
  t.tw = ((t.W + t.strips - 1) / t.strips + 1) & ~1;
  t.disp_scaling = disp_scaling, t.min_disp = min_disp;
  long long best = -1;
  for (int L = std::min(h, 4); L <= h; ++L) {
    const long long segs = (h + L - 1) / L, items = static_cast<long long>(B) * t.strips * segs;
    const long long cost = (items + slots - 1) / slots * (L + 2);
    if (best < 0 || cost < best) {
      best = cost;
      t.seg = L, t.segs = static_cast<int>(segs), t.items = static_cast<int>(items);
    }
  }
  return t;
}

// Returns cudaGetLastError() after the launch, -1 when the driver gives no
// cuTensorMapEncodeTiled, and -1000 - CUresult when it refuses x2's tensor map.
int launch(const void* x2, const void* d2, const void* prm, const float* disp1_host, void* out,
           int B, int h, int w, float disp_scaling, float min_disp, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  // x2 [B, h, w, 32] bf16 as a 4-D tensor (32, w, h, B), a box of one row of XCELLS cells
  CUtensorMap map;
  const cuuint64_t dims[4] = {CI, static_cast<cuuint64_t>(w), static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {CI * 2ull, CI * 2ull * w, CI * 2ull * w * h};
  const cuuint32_t box[4] = {CI, XCELLS, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = enc(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x2), dims,
                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return -1000 - static_cast<int>(r);
  cudaError_t err = cudaFuncSetAttribute(tail_bf16_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, tail_bf16_kernel, THREADS, SMEM);
  if (err != cudaSuccess) return err;
  const int slots = std::max(per_sm, 1) * sm_count();
  const Plan t = plan(B, h, w, slots, disp_scaling, min_disp);
  Disp1 hd;
  std::copy(disp1_host, disp1_host + 9 * CY, hd.w);
  hd.bias = disp1_host[9 * CY];
  tail_bf16_kernel<<<std::min(t.items, slots), THREADS, SMEM, stream>>>(
      map, static_cast<const float*>(d2), static_cast<const float*>(prm),
      static_cast<float*>(out), t, hd);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" int fused_tail_num_params() { return tc::N_ALL; }

// x2 [B,h,w,32] (bf16 if x2_is_bf16, else f32; bf16 16-byte aligned for TMA), d2 [B,h,w]
// f32, params: fused_tail_num_params() f32, out [B,2h,2w] f32; all contiguous on the
// current device. disp1_host: w_d1 (a, b, c) and b_d1, 145 f32 in host memory, read by the
// bf16 launch. Returns a cudaError_t, or tc::launch's negative codes.
extern "C" int fused_tail_launch(const void* x2, const void* d2, const void* params,
                                 const float* disp1_host, void* out, int B, int h, int w,
                                 int x2_is_bf16, float disp_scaling, float min_disp,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x2_is_bf16)
    return tc::launch(x2, d2, params, disp1_host, out, B, h, w, disp_scaling, min_disp, s);
  return static_cast<int>(launch_f32(x2, d2, params, out, B, h, w, disp_scaling, min_disp, s));
}
