// The int8 / bf16 tensor-core probe's gridded product, for Hopper (sm_90a):
// C[M,N] = A[M,K] . B[K,N], int8 -> int32 or bf16 -> float32.
//
// Replaces the TPU kernel of tools/probe_int8_dot2.py:47 make_pallas_grid (the
// pl.pallas_call at :60): an (8, 8) grid of 512x512 output tiles of a 4096^3 product,
// each step one full-K dot of a [512, 4096] row band of A and a [4096, 512] column band of
// B in VMEM. The 512x512 blocking comes from the TPU's VMEM and nothing on Hopper needs it.
//
// Bound on an H100 SXM at the probe's shapes (4096^3): 137.4 G operations, 0.0694 ms at
// 1,979 int8 TOPS and 0.139 ms at 989 bf16 TFLOP/s; the bytes (A and B read once, C
// written once: 100.7 MB int8, 134.2 MB bf16) take 0.030 / 0.040 ms at 3.35 TB/s.
// Operations bound it, and only wgmma fed from shared memory reaches that rate.
//
// Design (csrc/dot_tile.cuh): 128x256 output tiles (512 at 4096^2), one persistent block
// on each SM walking them in groups of 8 row tiles, so that the tiles in flight share
// their bands of A and B in the L2. A producer warp keeps a 4-stage TMA ring full (48 KB a
// stage: 128 bytes of K for 128 rows of A and 256 rows of B), and two consumer warpgroups
// issue m64n256 wgmma on each arrived stage, so the tensor cores need 48 bytes of operands
// a clock from the L2 at their full rate. The producer loads the next tile's stages while
// the consumers store the last one, and the stores go out through 32 KB of staging by TMA
// (tma_store_tile), so the consumers wait for the staging to be read, not for the 128 KB
// of a tile to reach memory. int8 reads B^T, written by the transpose kernel in the same
// call (16 MB each way at 4096^2, ~0.01 ms of HBM time); bf16 reads B as it is, N-major,
// through the descriptor's transpose bit.

#include "dot_tile.cuh"

namespace {
constexpr int BN = 256;
}

extern "C" {

// M, N and K multiples of 128, 128 and 64 (a ragged 256-column tile reads zeros past N);
// bf16 != 0 selects bf16; bt is B^T's scratch ([N, K], int8), used for int8. Returns
// cudaGetLastError() after the launches (dot_tile::launch_typed says which negative codes
// mean what).
int dot_grid_launch(const void* a, const void* b, void* bt, void* out, int M, int N, int K,
                    int bf16, void* stream) {
  return dot_tile::launch<BN, false>(a, b, bt, nullptr, out, M, N, K, 1, bf16, stream);
}

// the multiples M, N and K must be of
void dot_grid_tile(int* m, int* n, int* k) {
  *m = 128;
  *n = 128;
  *k = 64;
}

}  // extern "C"
