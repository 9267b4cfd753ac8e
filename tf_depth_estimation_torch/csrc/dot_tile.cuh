// The tensor-core probes' shared tile for Hopper (sm_90a), used by csrc/dot_grid.cu and
// csrc/dot_loop.cu: C[M,N] = sum over r < repeats of A[M,K] . B[K,N], int8 -> int32 or
// bf16 -> float32, A [M, K] and B [K, N] row-major and contiguous, C row-major.
//
// What bounds it on an H100: the tensor cores (989 dense bf16 TFLOP/s, 1,979 int8 TOPS)
// are reached only through wgmma, which reads its operands from shared memory through a
// 64-bit descriptor and keeps the sum in registers. mma.sync, which the first version of
// these kernels used through nvcuda::wmma, and a copy loop run by the same warps that do
// the products left the tensor cores waiting on shared-memory loads (4.6-15.4 % of the
// bound). So each block here is warp-specialised:
//   * warpgroup 2 is the producer: one thread keeps a ring of STAGES shared-memory stages
//     full with TMA (cp.async.bulk.tensor), each stage 128 bytes of K (64 bf16 or 128 int8
//     values) for a 128-row band of A and a BN-row band of B, written with the 128-byte
//     swizzle, and completion counted on the stage's "full" mbarrier in bytes;
//   * warpgroups 0 and 1 are the consumers: each issues wgmma.mma_async (m64nBNk16 bf16,
//     m64nBNk32 int8) on its 64 rows of A and the whole B band of an arrived stage, four
//     a stage, keeps one group in flight, and releases a stage on its "empty" mbarrier
//     when the group that read it is done;
//   * setmaxnreg gives the consumers 232 registers a thread and the producer 40;
//   * without REPEAT (dot_grid) the blocks are persistent, and a tile's output leaves
//     through shared-memory staging and TMA stores (tma_store_tile); with it (dot_loop)
//     each block keeps its stages for all the products and writes its sum once.
// The wgmma descriptors use the layout that TMA's 128-byte swizzle writes (layout type 1,
// 1024 bytes between groups of 8 rows); each 32-byte step of K within a stage moves the
// start address by 32 bytes (K-major) or by 16 rows of 128 bytes (bf16 B read N-major).
//
// B's layout (b_kmajor). wgmma takes int8 operands only K-major (no transpose bit for
// .s8), and the probes' B is [K, N] row-major, N-major. So for int8 the launcher first
// writes B^T [N, K] into a scratch buffer the caller allocates, by a transpose kernel in
// the same call (one more launch, counted by the wrapper), and the product reads that
// K-major. bf16 reads B N-major directly: the descriptor's transpose bit, with BN / 64
// boxes of 64 columns x 64 rows of K a stage, 8 KB apart (the LBO); transposing bf16 B
// first as well was slower (tools/dot_variants.py).
//
// The ragged edge. TMA fills the part of a box outside the matrix with zeros, so a tile
// that passes M or N, and a stage that passes K, compute with zeros there; the epilogue
// stores only inside [M, N].
//
// The order of the sum. Without REPEAT a tile's registers accumulate the whole K. With it,
// each product accumulates in its own registers (the first wgmma of a product overwrites
// them, scale-d = 0) and is then added to the sum, as the TPU probe's loop body adds
// acc + dot(A, B), so the sum over r runs in the plain version's order; where K is split
// into parts, each part's sum has its own plane and reduce_kernel adds the planes in
// part order (csrc/dot_loop.cu says why that stays within the plain version's limits).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "hopper.cuh"

// Everything here has internal linkage (the anonymous namespace), as in csrc/hopper.cuh.
namespace dot_tile {
namespace {

using namespace hopper;

constexpr int BM = 128;       // rows of a block's tile: two consumer warpgroups of 64
constexpr int KB = 128;       // bytes of K a stage: the 128-byte swizzle's row
constexpr int STAGES = 4;     // the ring
constexpr int THREADS = 384;  // consumer warpgroups 0 and 1, producer warpgroup 2
constexpr int KSTEPS = 4;     // wgmma a stage: 32 bytes of K each

template <typename T> struct Acc;
template <> struct Acc<signed char> { using type = int; };
template <> struct Acc<__nv_bfloat16> { using type = float; };
// whether the product reads B^T (K-major) rather than B (N-major)
template <typename T> __host__ __device__ constexpr bool b_kmajor() { return sizeof(T) == 1; }

// ---- wgmma of the probes' shapes (the rest of the PTX: csrc/hopper.cuh) -------------

// D[64, N] (+)= A[64, k] . B[k, N] for one warpgroup: A and B from shared memory through
// their descriptors, D in registers (N / 2 a thread); scale_d = 0 overwrites D.
template <int TNSP_B>
__device__ __forceinline__ void wgmma_bf16_n256(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, %131;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TNSP_B));
}

__device__ __forceinline__ void wgmma_s8_n256(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83,"
      "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]), "+r"(d[65]),
        "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]),
        "+r"(d[78]), "+r"(d[79]), "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]),
        "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]),
        "+r"(d[102]), "+r"(d[103]), "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]),
        "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]),
        "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <int TNSP_B>
__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(TNSP_B));
}

__device__ __forceinline__ void wgmma_s8_n128(int* d, uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      :
        "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]),
        "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),
        "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]),
        "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]),
        "+r"(d[54]), "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

template <typename T, int BN, int TNSP_B>
__device__ __forceinline__ void mma(typename Acc<T>::type* d, uint64_t a, uint64_t b,
                                    int scale_d) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (BN == 256) wgmma_s8_n256(d, a, b, scale_d);
    else wgmma_s8_n128(d, a, b, scale_d);
  } else {
    if constexpr (BN == 256) wgmma_bf16_n256<TNSP_B>(d, a, b, scale_d);
    else wgmma_bf16_n128<TNSP_B>(d, a, b, scale_d);
  }
}

// ---- the kernel --------------------------------------------------------------------

struct Params {
  void* out;     // C, or with parts > 1 the parts' sums [parts, M, N]
  int M, N;
  int repeats;
  int nk;        // stages of K: ceil(K * sizeof(T) / KB)
  int chunk;     // stages of K a part takes
  int parts;     // REPEAT: blocks a tile, which split K between them; else 1
  int tiles_m, tiles_n;
  int resident;  // REPEAT with chunk <= STAGES: each stage is loaded once and kept
};

// Output tile `id` in groups of 8 row tiles, so that the tiles in flight at one time
// share their bands of A and B in the L2.
__device__ __forceinline__ void tile_coords(int id, int tiles_m, int tiles_n, int& tm,
                                            int& tn) {
  constexpr int GROUP = 8;
  const int per_group = GROUP * tiles_n, first = id / per_group * GROUP;
  const int rows = min(tiles_m - first, GROUP), in = id % per_group;
  tm = first + in % rows;
  tn = in / rows;
}

// Store warpgroup wg's 64 rows of a tile (rows row0.., columns col0..) from its registers
// `v` through its 16 KB of staging at `stage`: four rounds of 64 columns, each two 8 KB
// boxes of 64 rows x 32 values in the 128-byte swizzle that `map` (C in boxes of 32 x 64)
// writes out with TMA. The warpgroup waits only for the staging to be read, never for
// the stores to reach memory, so they overlap its next tile's products.
template <int BN, typename AccT>
__device__ __forceinline__ void tma_store_tile(const AccT* v, const CUtensorMap* map,
                                               uint8_t* stage, uint32_t stage_addr, int wg,
                                               int row0, int col0) {
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const bool leader = tid == 0;
#pragma unroll
  for (int q = 0; q < BN / 64; ++q) {
    if (leader) bulk_wait<true>();  // the last round's boxes are read: the staging is free
    named_sync(1 + wg, 128);
#pragma unroll
    for (int jb = 0; jb < 8; ++jb) {  // 8-column blocks of this round's 64 columns
      const int j = 8 * q + jb, box = jb / 4, c = (jb % 4) * 8 + (lane % 4) * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = warp * 16 + lane / 4 + 8 * h;
        const int off = box * 8192 + row * 128 + (((c / 4) ^ (row % 8)) << 4) + (c % 4) * 4;
        AccT* o = reinterpret_cast<AccT*>(stage + off);
        o[0] = v[4 * j + 2 * h];
        o[1] = v[4 * j + 2 * h + 1];
      }
    }
    fence_async_smem();
    named_sync(1 + wg, 128);
    if (leader) {
      tma_store(map, stage_addr, col0 + 64 * q, row0);
      tma_store(map, stage_addr + 8192, col0 + 64 * q + 32, row0);
      bulk_commit();
    }
  }
}

template <int BN, typename AccT>
__device__ __forceinline__ void store_tile(const AccT* v, AccT* out, int row0, int col0, int M,
                                           int N) {
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = col0 + 8 * j;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < M && col < N) {
        AccT* o = out + static_cast<size_t>(row) * N + col;
        if constexpr (std::is_same<AccT, float>::value)
          *reinterpret_cast<float2*>(o) = make_float2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
        else
          *reinterpret_cast<int2*>(o) = make_int2(v[4 * j + 2 * h], v[4 * j + 2 * h + 1]);
      }
    }
  }
}

// One block of 384 threads; dynamic shared memory: STAGES stages of [A: BM x KB | B: BN x
// KB] bytes, 1024-aligned, then (without REPEAT) 32 KB of staging for the stores, then the
// mbarriers. Without REPEAT the grid is persistent: block b takes tiles b, b + gridDim.x,
// ...; with it the grid holds `parts` blocks for each tile, block b taking part b % parts
// of K, and each part's sum goes to its own plane of p.out.
template <typename T, int BN, bool REPEAT>
__global__ void __launch_bounds__(THREADS, 1)
dot_kernel(const __grid_constant__ CUtensorMap mapA, const __grid_constant__ CUtensorMap mapB,
           const __grid_constant__ CUtensorMap mapC, const Params p) {
  using AccT = typename Acc<T>::type;
  constexpr bool B_KMAJOR = b_kmajor<T>();
  constexpr int A_BYTES = BM * KB, B_BYTES = BN * KB, STAGE = A_BYTES + B_BYTES;
  constexpr int KE = KB / sizeof(T);  // values of K a stage
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* const smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t sbase = smem_addr(smem);
  constexpr int STAGING = REPEAT ? 0 : 2 * 16384;  // the tiles' stores (tma_store_tile)
  const uint32_t bars = sbase + STAGES * STAGE + STAGING;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (STAGES + s); };
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 2);  // one arrival from each consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");  // for TMA
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int tiles = p.tiles_m * p.tiles_n;
  const int part = blockIdx.x % p.parts, first = blockIdx.x / p.parts;
  const int stride = gridDim.x / p.parts;
  const int kbeg = part * p.chunk, kend = min(p.nk, kbeg + p.chunk);
  const int reps = REPEAT ? p.repeats : 1;

  if (wg == 2) {  // the producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      int t = 0;
      for (int id = first; id < tiles; id += stride) {
        int tm, tn;
        tile_coords(id, p.tiles_m, p.tiles_n, tm, tn);
        for (int r = 0; r < (p.resident ? 1 : reps); ++r)
          for (int s = kbeg; s < kend; ++s, ++t) {
            const int slot = t % STAGES;
            mbar_wait(empty(slot), ((t / STAGES) & 1) ^ 1);
            mbar_expect_tx(full(slot), STAGE);
            const uint32_t a = sbase + slot * STAGE, b = a + A_BYTES;
            tma_load(a, &mapA, full(slot), s * KE, tm * BM);
            if constexpr (B_KMAJOR) {
              tma_load(b, &mapB, full(slot), s * KE, tn * BN);
            } else {
#pragma unroll
              for (int j = 0; j < BN / 64; ++j)
                tma_load(b + j * 64 * KB, &mapB, full(slot), tn * BN + 64 * j, s * KE);
            }
          }
      }
    }
    return;
  }

  // the consumers: warpgroup wg computes rows [64 wg, 64 wg + 64) of the tile
  setmaxnreg_inc<232>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  AccT acc[BN / 2], sum[BN / 2];  // a product's registers and the sum of the products
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = sum[j] = AccT(0);
  int t = 0;
  for (int id = first; id < tiles; id += stride) {
    int tm, tn;
    tile_coords(id, p.tiles_m, p.tiles_n, tm, tn);
    if constexpr (REPEAT) {
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sum[j] = AccT(0);
    }
    for (int r = 0; r < reps; ++r) {
      int prev = 0;
      for (int s = kbeg; s < kend; ++s) {
        const int i = s - kbeg;
        // resident: stage i, loaded once (the wait passes at once after the first
        // product); else the ring's next stage
        const int slot = p.resident ? i : t % STAGES;
        mbar_wait(full(slot), p.resident ? 0 : (t / STAGES) & 1);
        const uint32_t a = sbase + slot * STAGE + wg * 64 * KB;
        const uint32_t b = sbase + slot * STAGE + A_BYTES;
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < KSTEPS; ++k) {
          const uint64_t da = desc(a + 32 * k, 16, 1024);
          const uint64_t db = B_KMAJOR ? desc(b + 32 * k, 16, 1024)
                                       : desc(b + 16 * KB * k, 64 * KB, 1024);
          mma<T, BN, B_KMAJOR ? 0 : 1>(acc, da, db, (i > 0 || k > 0) ? 1 : 0);
        }
        wgmma_commit();
        if (!p.resident) {
          if (i > 0) {  // the group before this one is done: its stage is free
            wgmma_wait<1>();
            if (threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
          }
          prev = slot;
          ++t;
        }
      }
      wgmma_wait<0>();
      if (kend > kbeg) {
        if (!p.resident && threadIdx.x % 128 == 0) mbar_arrive(empty(prev));
        if constexpr (REPEAT) {  // the product is done: sum = sum + product
#pragma unroll
          for (int j = 0; j < BN / 2; ++j) sum[j] += acc[j];
        }
      }
    }
    if constexpr (REPEAT) {  // once a block: straight from the registers
      AccT* const out = static_cast<AccT*>(p.out) + static_cast<size_t>(part) * p.M * p.N;
      store_tile<BN>(sum, out, tm * BM + wg * 64 + warp * 16 + lane / 4,
                     tn * BN + (lane % 4) * 2, p.M, p.N);
    } else {
      const int off = STAGES * STAGE + wg * 16384;
      tma_store_tile<BN>(acc, &mapC, smem + off, sbase + off, wg, tm * BM + wg * 64, tn * BN);
    }
  }
  if (!REPEAT && threadIdx.x % 128 == 0) bulk_wait<false>();  // the last stores are done
}

// out [cols, rows] = in [rows, cols]^T for 1- or 2-byte values (U = uint8_t or uint16_t),
// 64 x 64 values a block through shared memory, 32-bit words in and out; rows and cols
// multiples of 64
template <typename U>
__global__ void __launch_bounds__(256)
transpose_kernel(const U* __restrict__ in, U* __restrict__ out, int rows, int cols) {
  constexpr int W = 4 / sizeof(U);  // values a word
  constexpr int WPR = 64 / W;       // words a 64-value row
  __shared__ __align__(4) U tile[64][64 + W];
  const int r0 = blockIdx.y * 64, c0 = blockIdx.x * 64;
  for (int i = threadIdx.x; i < 64 * WPR; i += 256) {
    const int r = i / WPR, w = i % WPR;
    *reinterpret_cast<uint32_t*>(&tile[r][w * W]) = *reinterpret_cast<const uint32_t*>(
        in + static_cast<size_t>(r0 + r) * cols + c0 + w * W);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < 64 * WPR; i += 256) {
    const int c = i / WPR, w = i % WPR;
    uint32_t v = 0;
#pragma unroll
    for (int j = 0; j < W; ++j)
      v |= static_cast<uint32_t>(tile[w * W + j][c]) << (8 * sizeof(U) * j);
    *reinterpret_cast<uint32_t*>(out + static_cast<size_t>(c0 + c) * rows + r0 + w * W) = v;
  }
}

// out[i] = parts[0][i] + parts[1][i] + ..., added in that order; n a multiple of 4
template <typename AccT>
__global__ void __launch_bounds__(256)
reduce_kernel(const AccT* __restrict__ parts, AccT* __restrict__ out, int count, size_t n) {
  using V = typename std::conditional<std::is_same<AccT, float>::value, float4, int4>::type;
  for (size_t i = 4 * (static_cast<size_t>(blockIdx.x) * 256 + threadIdx.x); i < n;
       i += 4 * static_cast<size_t>(gridDim.x) * 256) {
    V v = *reinterpret_cast<const V*>(parts + i);
    for (int q = 1; q < count; ++q) {
      const V w = *reinterpret_cast<const V*>(parts + q * n + i);
      v.x += w.x, v.y += w.y, v.z += w.z, v.w += w.w;
    }
    *reinterpret_cast<V*>(out + i) = v;
  }
}

// ---- the host side (the tensor-map encoder and sm_count: csrc/hopper.cuh) ---------

// a 2-D row-major matrix [outer, inner] of `type`, `esize` bytes a value, in boxes of
// [box_outer, box_inner] with the 128-byte swizzle; out of bounds reads as zeros and is not
// written
inline CUresult make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr,
                         CUtensorMapDataType type, int esize, uint64_t inner, uint64_t outer,
                         uint32_t box_inner, uint32_t box_outer) {
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * esize};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, type, 2,
             const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The parts K is split into for a loop of products (REPEAT): as few as let each part's
// stages stay in the ring, at most 8 (beyond that each part streams through the ring once
// a product).
inline int loop_parts(int K, int esize) {
  const int nk = (K * esize + KB - 1) / KB;
  const int c = std::min(8, (nk + STAGES - 1) / STAGES);
  const int chunk = (nk + c - 1) / c;
  return (nk + chunk - 1) / chunk;
}

// Launch on `stream`: for a K-major B (int8) first the transpose of b into bt ([N, K],
// allocated by the caller); then the product; then, for a loop of products whose K is
// split into parts > 1 (loop_parts), the sum of the parts' planes of `parts` ([parts, M,
// N], allocated by the caller) into out. M, N and K are multiples of 64. Returns
// cudaGetLastError() after the launches, -1 when the driver gives no
// cuTensorMapEncodeTiled, and -1000 - CUresult when it refuses a tensor map.
template <typename T, int BN, bool REPEAT>
int launch_typed(const void* a, const void* b, void* bt, void* parts, void* out, int M, int N,
                 int K, int repeats, cudaStream_t stream) {
  using AccT = typename Acc<T>::type;
  constexpr int E = sizeof(T);
  constexpr bool B_KMAJOR = b_kmajor<T>();
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return -1;
  const void* bk = b;
  if constexpr (B_KMAJOR) {
    using U = typename std::conditional<E == 1, uint8_t, uint16_t>::type;
    transpose_kernel<U><<<dim3(N / 64, K / 64), 256, 0, stream>>>(
        static_cast<const U*>(b), static_cast<U*>(bt), K, N);
    bk = bt;
  }
  const CUtensorMapDataType in_type =
      E == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const CUtensorMapDataType out_type =
      E == 1 ? CU_TENSOR_MAP_DATA_TYPE_INT32 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap mapA, mapB, mapC;
  CUresult r = make_map(enc, &mapA, a, in_type, E, K, M, KB / E, BM);
  if (r == CUDA_SUCCESS)
    r = B_KMAJOR ? make_map(enc, &mapB, bk, in_type, E, K, N, KB / E, BN)
                 : make_map(enc, &mapB, bk, in_type, E, N, K, 64, KB / E);
  if (r == CUDA_SUCCESS && !REPEAT) r = make_map(enc, &mapC, out, out_type, 4, N, M, 32, 64);
  if (r != CUDA_SUCCESS) return -1000 - static_cast<int>(r);

  Params p;
  p.M = M, p.N = N, p.repeats = repeats;
  p.nk = (K * E + KB - 1) / KB;
  p.tiles_m = (M + BM - 1) / BM, p.tiles_n = (N + BN - 1) / BN;
  const int tiles = p.tiles_m * p.tiles_n;
  int grid;
  if (REPEAT) {
    p.parts = loop_parts(K, E);
    p.chunk = (p.nk + p.parts - 1) / p.parts;
    p.resident = p.chunk <= STAGES;
    grid = tiles * p.parts;
  } else {
    p.chunk = p.nk, p.parts = 1, p.resident = 0;
    grid = std::min(tiles, sm_count());
  }
  p.out = p.parts > 1 ? parts : out;
  constexpr int SMEM =
      STAGES * (BM + BN) * KB + (REPEAT ? 0 : 2 * 16384) + 2 * STAGES * 8 + 1024;
  const auto kernel = dot_kernel<T, BN, REPEAT>;
  static bool sized = false;
  if (!sized) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    sized = true;
  }
  kernel<<<grid, THREADS, SMEM, stream>>>(mapA, mapB, REPEAT ? mapA : mapC, p);
  if constexpr (REPEAT) {
    if (p.parts > 1) {
      const size_t n = static_cast<size_t>(M) * N;
      const int blocks =
          static_cast<int>(std::min<size_t>((n / 4 + 255) / 256, 8 * sm_count()));
      reduce_kernel<AccT><<<blocks, 256, 0, stream>>>(static_cast<const AccT*>(parts),
                                                      static_cast<AccT*>(out), p.parts, n);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// bf16 != 0 selects bf16, else int8
template <int BN, bool REPEAT>
int launch(const void* a, const void* b, void* bt, void* parts, void* out, int M, int N, int K,
           int repeats, int bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return launch_typed<__nv_bfloat16, BN, REPEAT>(a, b, bt, parts, out, M, N, K, repeats, s);
  return launch_typed<signed char, BN, REPEAT>(a, b, bt, parts, out, M, N, K, repeats, s);
}

}  // namespace
}  // namespace dot_tile
