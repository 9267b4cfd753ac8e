// The int8 / bf16 tensor-core probe's gridded product, for Hopper (sm_90a):
// C[M,N] = A[M,K] . B[K,N], int8 -> int32 or bf16 -> float32.
//
// Replaces the TPU kernel of tools/probe_int8_dot2.py:47 make_pallas_grid (the
// pl.pallas_call at :60): an (8, 8) grid of 512x512 output tiles of a 4096^3 product,
// each step one full-K dot of a [512, 4096] row band of A and a [4096, 512] column band of
// B in VMEM. The 512x512 blocking comes from the TPU's VMEM and nothing on Hopper needs
// it: here a grid of 128x128 output tiles (1,024 blocks at 4096^2), 8 warps of 64x32
// each, loops over the whole K in 64-byte stages through shared memory
// (csrc/dot_tile.cuh), the copy of the next stage in flight while the tensor cores work
// on the current one.
//
// Bound on an H100 SXM at the probe's shapes (4096^3): 137.4 G operations, 0.0694 ms at
// 1,979 int8 TOPS and 0.139 ms at 989 bf16 TFLOP/s; the bytes (A and B read once, C
// written once: 100.7 MB int8, 134.2 MB bf16) take 0.030 / 0.040 ms at 3.35 TB/s.
// Operations bound it. This first version uses wmma's mma.sync, not wgmma and TMA, so it
// reaches a fraction of that rate; chip_smoke.py prints the share.

#include "dot_tile.cuh"

namespace {
constexpr int BM = 128, BN = 128, WARPS_M = 2, WARPS_N = 4;
}

extern "C" {

// M, N multiples of 128, K a multiple of 64; bf16 != 0 selects the bf16 instantiation.
// Returns cudaGetLastError() after the launch.
int dot_grid_launch(const void* a, const void* b, void* out, int M, int N, int K, int bf16,
                    void* stream) {
  return dot_tile::launch<BM, BN, WARPS_M, WARPS_N, false>(a, b, out, M, N, K, 1, bf16,
                                                           stream);
}

// the multiples M, N and K must be of
void dot_grid_tile(int* m, int* n, int* k) {
  *m = BM;
  *n = BN;
  *k = dot_tile::KB;
}

}  // extern "C"
