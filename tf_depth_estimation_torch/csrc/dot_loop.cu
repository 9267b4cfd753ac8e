// The int8 / bf16 tensor-core probe's loop of products, for Hopper (sm_90a):
// out[M,N] = sum over r < repeats of A[M,K] . B[K,N], int8 -> int32 or bf16 -> float32.
//
// Replaces the TPU kernel tools/probe_int8_dot.py:29 _dot_loop_kernel (entry point
// make_pallas, :43), which holds A and B whole in VMEM (1 + 1 MB int8, 2 + 2 MB bf16) and
// adds R = 64 products of 1024^3 in a fori_loop, so that no HBM traffic enters the loop.
// No Hopper block holds that (227 KB of shared memory a block), so here a grid of 64x64
// output tiles (256 blocks at 1024^2) walks r in an outer loop and 64-byte stages of K
// in an inner one through shared memory (csrc/dot_tile.cuh); A and B (2 or 4 MB) stay
// in the 50 MB L2, so the loop still reads no HBM after the first product. Every one of
// the R products is issued: folding them into R . (A . B) would be another probe, with a
// false count of operations. Each product accumulates in its own fragments and is then
// added to the sum, as the TPU loop body's acc + dot does.
//
// Bound on an H100 SXM at the probe's shapes (1024^3, R = 64): 137.4 G multiply-adds x 2
// = 137.4 G operations, 0.0694 ms at 1,979 int8 TOPS and 0.139 ms at 989 bf16 TFLOP/s;
// the bytes (A and B read once, out written once: 6 MB int8, 8 MB bf16) take 2-3 us at
// 3.35 TB/s. Operations bound it. This first version uses wmma's mma.sync, not wgmma and
// TMA, so it reaches a fraction of that rate; chip_smoke.py prints the share.

#include "dot_tile.cuh"

namespace {
constexpr int BM = 64, BN = 64, WARPS_M = 2, WARPS_N = 2;
}

extern "C" {

// M, N multiples of 64, K a multiple of 64, repeats >= 1; bf16 != 0 selects the bf16
// instantiation. Returns cudaGetLastError() after the launch.
int dot_loop_launch(const void* a, const void* b, void* out, int M, int N, int K,
                    int repeats, int bf16, void* stream) {
  return dot_tile::launch<BM, BN, WARPS_M, WARPS_N, true>(a, b, out, M, N, K, repeats,
                                                          bf16, stream);
}

// the multiples M, N and K must be of
void dot_loop_tile(int* m, int* n, int* k) {
  *m = BM;
  *n = BN;
  *k = dot_tile::KB;
}

}  // extern "C"
