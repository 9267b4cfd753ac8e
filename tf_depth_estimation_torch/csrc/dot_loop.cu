// The int8 / bf16 tensor-core probe's loop of products, for Hopper (sm_90a):
// out[M,N] = sum over r < repeats of A[M,K] . B[K,N], int8 -> int32 or bf16 -> float32.
//
// Replaces the TPU kernel tools/probe_int8_dot.py:29 _dot_loop_kernel (entry point
// make_pallas, :43), which holds A and B whole in VMEM (1 + 1 MB int8, 2 + 2 MB bf16) and
// adds R = 64 products of 1024^3 in a fori_loop, so that no HBM traffic enters the loop.
// Every one of the R products is issued: folding them into R . (A . B) would be another
// probe, with a false count of operations.
//
// Bound on an H100 SXM at the probe's shapes (1024^3, R = 64): 137.4 G operations, 0.0694
// ms at 1,979 int8 TOPS and 0.139 ms at 989 bf16 TFLOP/s; the bytes (A and B read once,
// out written once: 6 MB int8, 8 MB bf16) take 2-3 us at 3.35 TB/s. Operations bound it.
//
// The L2 is the wall short of that: a block that read its bands of A and B again for each
// product would move M N K (1/BM + 1/BN) values a product from the L2, 2.1 GB (int8) or
// 4.3 GB (bf16) a call with 64x64 tiles, ~31 TB/s to finish in the bound. So a block keeps
// its bands in shared memory across the R products (csrc/dot_tile.cuh, REPEAT): the tile
// is 128x128 (two consumer warpgroups of m64n128 wgmma), and K is split into parts small
// enough for the 4-stage ring, 4 stages of 128 bytes of K (512 bytes, 128 KB of A and B),
// each part taken by its own block: at the probe's shapes 2 parts (int8, 128 blocks: one
// wave on 132 SMs) or 4 (bf16, 256 blocks: two waves). Each block loads its bands once
// (16.8 MB int8, 33.5 MB bf16 from the L2 a call, besides int8's 1 MB transpose), runs the
// R products from shared memory, each accumulated in its own registers and then added to
// its sum, and writes its part's sum to a plane of a scratch buffer; one more launch adds
// the planes in part order (4 + 2 MB int8, 16 + 4 MB bf16, most of it in the L2). A K too
// long for 8 parts of 4 stages streams through the ring once a product instead.
//
// Why not a cluster that adds its blocks' sums through distributed shared memory: with 4
// blocks a cluster (bf16), one block an SM, fewer than 32 clusters fit on the card at
// once, and an earlier version of this kernel ran the 64 clusters in 3 waves; independent
// blocks run in 2.
//
// The order of the sum: the plain version adds R float32 products in turn. With K split
// in C parts, each block adds its R partial products in turn and the C sums are added at
// the end. int8 stays exact (each partial sum is bounded by the whole one, below 2^31).
// For bf16 each of the two orders rounds R - 1 + C - 1 additions of values no larger
// than the result (at most (R + C) 2^-24 of it, 3.9e-6 at R = 64, C = 4), next to the
// tensor cores' K/16 round-toward-zero steps that bf16_rtol(K) allows (3.1e-5 at K =
// 1024); the split does not change how many K steps a product has.

#include "dot_tile.cuh"

namespace {
constexpr int BN = 128;
}

extern "C" {

// M, N and K multiples of 64 (a ragged 128-row or -column tile reads zeros past M or N),
// repeats >= 1; bf16 != 0 selects bf16; bt is B^T's scratch ([N, K], int8), used for int8;
// parts is the scratch of the K parts' sums ([dot_loop_parts(K, bf16), M, N], the output's
// type), used when there are two or more. Returns cudaGetLastError() after the launches
// (dot_tile::launch_typed says which negative codes mean what).
int dot_loop_launch(const void* a, const void* b, void* bt, void* parts, void* out, int M,
                    int N, int K, int repeats, int bf16, void* stream) {
  return dot_tile::launch<BN, true>(a, b, bt, parts, out, M, N, K, repeats, bf16, stream);
}

// the parts K is split into: planes of the parts scratch (1: none needed)
int dot_loop_parts(int K, int bf16) { return dot_tile::loop_parts(K, bf16 ? 2 : 1); }

// the multiples M, N and K must be of
void dot_loop_tile(int* m, int* n, int* k) {
  *m = 64;
  *n = 64;
  *k = 64;
}

}  // extern "C"
