// A block-tiled matrix product on tensor cores, shared by csrc/dot_loop.cu and
// csrc/dot_grid.cu (sm_90a): int8 x int8 -> int32 and bf16 x bf16 -> float32.
//
// C[M,N] = sum over r < repeats of A[M,K] . B[K,N], A and B row-major and contiguous, C
// row-major. One block computes a BM x BN tile of C with WARPS_M x WARPS_N warps, each a
// (BM / WARPS_M) x (BN / WARPS_N) sub-tile of 16x16 fragments. The block walks repeats x
// (K / BK) stages of BK values of K, two stages in shared memory: while the tensor cores
// work on one stage, cp.async copies the next from global memory (the L2 for the
// repeated stages), 16 bytes a thread and copy. Shared memory holds each 16x16 block of
// A and of B as 256 (int8) or 512 (bf16) contiguous bytes, so every fragment load reads
// one aligned block with a leading dimension of 16 values. The products run through
// nvcuda::wmma m16n16k16 (s8 -> s32, bf16 -> f32), which compiles to mma.sync.
//
// With REPEAT, each product of the R accumulates in its own fragments, which are added
// to the sum when its last stage is done, as the TPU probe's loop body adds
// acc + dot(A, B); so the sum over r is taken in the order the plain version takes it.
// Without it (a single product) the fragments accumulate the whole K.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace dot_tile {

using namespace nvcuda;

constexpr int KB = 64;  // bytes of K a stage: 64 int8 or 32 bf16 values

template <typename T> struct Acc;
template <> struct Acc<signed char> { using type = int; };
template <> struct Acc<__nv_bfloat16> { using type = float; };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <typename T, int BM, int BN, int WARPS_M, int WARPS_N, bool REPEAT>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32)
dot_kernel(const T* __restrict__ A, const T* __restrict__ B,
           typename Acc<T>::type* __restrict__ C, int N, int K, int repeats) {
  using AccT = typename Acc<T>::type;
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int E = 16 / sizeof(T);         // values in a 16-byte copy
  constexpr int BK = KB / sizeof(T);        // values of K a stage
  constexpr int KS = BK / 16;               // fragment steps a stage
  constexpr int FM = BM / WARPS_M / 16, FN = BN / WARPS_N / 16;
  constexpr int A_BYTES = BM * KB, B_BYTES = BN * KB;  // a stage
  constexpr int B_ROW_COPIES = BN * (int)sizeof(T) / 16;
  static_assert(BM % (WARPS_M * 16) == 0 && BN % (WARPS_N * 16) == 0, "warp tiling");
  static_assert((A_BYTES / 16) % THREADS == 0 && (B_BYTES / 16) % THREADS == 0,
                "copies a thread");

  // stage s: A as [KS][BM][16] values, B as [BN / 16][BK][16]
  __shared__ __align__(128) unsigned char smem[2 * (A_BYTES + B_BYTES)];
  T* const As = reinterpret_cast<T*>(smem);
  T* const Bs = reinterpret_cast<T*>(smem + 2 * A_BYTES);

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32, wm = warp / WARPS_N, wn = warp % WARPS_N;

  auto load_stage = [&](int s, int k0) {
    T* a = As + s * (A_BYTES / sizeof(T));
    T* b = Bs + s * (B_BYTES / sizeof(T));
    for (int i = threadIdx.x; i < A_BYTES / 16; i += THREADS) {
      const int r = i / (KB / 16), kl = (i % (KB / 16)) * E;
      cp_async16(a + ((kl / 16) * BM + r) * 16 + kl % 16,
                 A + (size_t)(m0 + r) * K + k0 + kl);
    }
    for (int i = threadIdx.x; i < B_BYTES / 16; i += THREADS) {
      const int kr = i / B_ROW_COPIES, nl = (i % B_ROW_COPIES) * E;
      cp_async16(b + ((nl / 16) * BK + kr) * 16 + nl % 16,
                 B + (size_t)(k0 + kr) * N + n0 + nl);
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, AccT> sum[FM][FN], prod[FM][FN];
  for (int i = 0; i < FM; ++i)
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(sum[i][j], AccT(0));
      wmma::fill_fragment(prod[i][j], AccT(0));
    }
  auto& acc = REPEAT ? prod : sum;

  const int nk = K / BK, total = repeats * nk;
  load_stage(0, 0);
  cp_async_commit();
  for (int t = 0; t < total; ++t) {
    if (t + 1 < total) load_stage((t + 1) & 1, ((t + 1) % nk) * BK);
    cp_async_commit();
    cp_async_wait<1>();  // every copy but the stage just started has landed
    __syncthreads();
    const T* a = As + (t & 1) * (A_BYTES / sizeof(T));
    const T* b = Bs + (t & 1) * (B_BYTES / sizeof(T));
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a + (ks * BM + (wm * FM + i) * 16) * 16, 16);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b + ((wn * FN + j) * BK + ks * 16) * 16, 16);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
    __syncthreads();  // the stage is read before the next iteration refills it
    if (REPEAT && (t + 1) % nk == 0) {  // a product is done: sum = sum + product
      for (int i = 0; i < FM; ++i)
        for (int j = 0; j < FN; ++j) {
          for (int e = 0; e < sum[i][j].num_elements; ++e) sum[i][j].x[e] += prod[i][j].x[e];
          wmma::fill_fragment(prod[i][j], AccT(0));
        }
    }
  }
  for (int i = 0; i < FM; ++i)
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(
          C + (size_t)(m0 + (wm * FM + i) * 16) * N + n0 + (wn * FN + j) * 16, sum[i][j],
          N, wmma::mem_row_major);
}

// Launch on `stream`: grid of (N / BN, M / BM) blocks; the caller checks that M, N and K
// are multiples of BM, BN and KB. Returns cudaGetLastError().
template <int BM, int BN, int WARPS_M, int WARPS_N, bool REPEAT>
int launch(const void* a, const void* b, void* c, int M, int N, int K, int repeats,
           int bf16, void* stream) {
  const dim3 grid(N / BN, M / BM), block(WARPS_M * WARPS_N * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    dot_kernel<__nv_bfloat16, BM, BN, WARPS_M, WARPS_N, REPEAT><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
        static_cast<float*>(c), N, K, repeats);
  else
    dot_kernel<signed char, BM, BN, WARPS_M, WARPS_N, REPEAT><<<grid, block, 0, s>>>(
        static_cast<const signed char*>(a), static_cast<const signed char*>(b),
        static_cast<int*>(c), N, K, repeats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dot_tile
