// Fused per-participant limb share + participant reduction for Hopper (sm_90a).
//
// Replaces sda_tpu/parallel/limb_pallas.py:participant_limb_sums_pallas.
//
//   in : values (C, nb, K) int32, canonical residues 0 <= x < p < 2^31
//        stacks  packed from fold_const_limbs' (L, L*K, n) int8 stacks,
//                laid out (n_tiles, K, 5, 8, 8) int8 = (n_tiles, K, 5, 8, 2) int32
//                (tile, kk, m, clerk-in-tile, limb i; limbs i >= L and clerks
//                >= n are zero)
//   out: (L, nb, n) int32, zeroed by the caller;
//        out[m, b, j] = sum_c sum_{i, kk} limb_i(values[c, b, kk]) * stacks[m, i*K + kk, j]
//
// Every participant's per-(b, m, j) share partial is formed (this is the
// per-participant engine, not the sum-first one) and summed over the
// participant axis; nothing of it reaches device memory.
//
// Design. One thread per batch row b and column tile of 8 clerks, looping over
// a slice of kParticipants participants. A value's five base-128 limbs are
// packed into two int32 words (bytes: limbs 0-3, limb 4), so each (m, clerk)
// term is two __dp4a against the tile's packed stacks, which sit in shared
// memory (K * 320 bytes: 2,240 at K = 7) and are read as broadcasts. The L x 8
// accumulators live in registers. The TPU grid ran in order and did
// `out_ref +=` across steps; CUDA blocks run in no order, so each thread adds
// its slice's partial into the output with int32 atomicAdd. Integer addition
// is exact and order-free: every partial sum is bounded by C*L*K*127^2, which
// the wrapper checks is < 2^31 before launching. Ragged participant and batch
// edges are masked here (no block-size divisor needed).
//
// Bound per chunk at full width (C = 2000, nb = 2000, K = 7, L = 5, n = 8):
// 112 MB of int32 values read once -> 33.4 us at 3.35 TB/s; 5.6e9 int8 MACs
// (1.1e10 operations) -> 5.7 us at the 1,979 TOP/s int8 tensor-core peak. So
// the function is bound by bytes. This CUDA-core __dp4a version issues
// 2*5*8*K dp4a per (participant, row) and is bound by those instructions well
// above that floor; tensor cores (mma.sync m16n8k32 s8, whose N = 8 matches
// the clerk tile, then wgmma/TMA) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 128;         // batch rows per block, one per thread
constexpr int kTile = 8;           // clerks per column tile
constexpr int kLimbs = 5;          // limb slots: p < 2^31 has at most 5
constexpr int kParticipants = 32;  // participants per block
constexpr int kWordsPerKk = kLimbs * kTile * 2;  // packed int32 words per kk

__global__ void __launch_bounds__(kRows) limb_share_sum_kernel(
    const int32_t* __restrict__ values, const int32_t* __restrict__ stacks,
    int32_t* __restrict__ out, int C, int nb, int K, int L, int n) {
  extern __shared__ int4 s_stacks[];  // (K, kLimbs, kTile / 2) int4
  const int tile = blockIdx.y;
  const int words = K * kWordsPerKk;
  const int4* src = reinterpret_cast<const int4*>(stacks + (size_t)tile * words);
  for (int w = threadIdx.x; w < words / 4; w += blockDim.x) s_stacks[w] = src[w];
  __syncthreads();

  const int b = blockIdx.x * kRows + threadIdx.x;
  if (b >= nb) return;
  const int c0 = blockIdx.z * kParticipants;
  const int c1 = min(C, c0 + kParticipants);

  int acc[kLimbs][kTile];
#pragma unroll
  for (int m = 0; m < kLimbs; ++m)
#pragma unroll
    for (int j = 0; j < kTile; ++j) acc[m][j] = 0;

  for (int c = c0; c < c1; ++c) {
    const int32_t* row = values + ((size_t)c * nb + b) * K;
    for (int kk = 0; kk < K; ++kk) {
      const int x = row[kk];
      // limbs 0..3 as bytes 0..3, limb 4 alone in the second word
      const int w0 = (x & 0x7F) | ((x << 1) & 0x7F00) | ((x << 2) & 0x7F0000) |
                     ((x << 3) & 0x7F000000);
      const int w1 = (x >> 28) & 0x7F;
      const int4* s = s_stacks + kk * (kWordsPerKk / 4);
#pragma unroll
      for (int m = 0; m < kLimbs; ++m) {
#pragma unroll
        for (int j = 0; j < kTile; j += 2) {
          const int4 q = s[(m * kTile + j) / 2];  // clerk j: (x, y), j+1: (z, w)
          acc[m][j] = __dp4a(w0, q.x, acc[m][j]);
          acc[m][j] = __dp4a(w1, q.y, acc[m][j]);
          acc[m][j + 1] = __dp4a(w0, q.z, acc[m][j + 1]);
          acc[m][j + 1] = __dp4a(w1, q.w, acc[m][j + 1]);
        }
      }
    }
  }

  const int j0 = tile * kTile;
#pragma unroll
  for (int m = 0; m < kLimbs; ++m) {
    if (m >= L) break;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if (j0 + j < n) atomicAdd(&out[((size_t)m * nb + b) * n + j0 + j], acc[m][j]);
    }
  }
}

}  // namespace

extern "C" int limb_share_sum_launch(const int32_t* values, const int32_t* stacks,
                                     int32_t* out, int C, int nb, int K, int L,
                                     int n, void* stream) {
  const int n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid((nb + kRows - 1) / kRows, n_tiles,
                  (C + kParticipants - 1) / kParticipants);
  const size_t smem = (size_t)K * kWordsPerKk * sizeof(int32_t);
  limb_share_sum_kernel<<<grid, kRows, smem, static_cast<cudaStream_t>(stream)>>>(
      values, stacks, out, C, nb, K, L, n);
  return static_cast<int>(cudaGetLastError());
}
