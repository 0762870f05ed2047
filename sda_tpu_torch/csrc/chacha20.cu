// ChaCha20 keystream blocks for Hopper (sm_90a).
//
// Replaces sda_tpu/ops/chacha_pallas.py:_rounds_pallas (kernel body
// _rounds_kernel), reached through chacha_blocks_pallas and _rounds from
// expand_seeds_counts: the seed-masking expansion that participants mask with
// and the recipient re-runs for every seed at reveal.
//
//   in : keys (P, 8) uint32 (as int32 bits), each seed's words zero-padded
//        to a 256-bit key; first_counter; n_blocks
//   out: (P, n_blocks, 16) uint32 (as int32 bits); row (s, j) is djb ChaCha20
//        block number first_counter + j of key s (zero nonce, 64-bit counter
//        over words 12-13), 20 rounds plus the feed-forward
//
// Design. One thread per block. It builds the initial state in registers
// (constants, key, counter low and high word with the carry, zero nonce) and
// runs the 10 double rounds fully unrolled with 16 + 16 live words, rotating
// by __funnelshift_l. So the only device-memory traffic is the 32-byte key
// (shared by a seed's n_blocks threads, so read from cache) and the 64-byte
// block written as four 16-byte stores. The TPU kernel read a (16, N) state
// tensor built outside in XLA and kept a transposed lane layout with 512-block
// VMEM tiles; neither is carried over.
//
// Bound per chunk of the masked path (2,000 seeds x 1,251 blocks): 976 32-bit
// integer operations per block (80 quarter rounds x 12, rotates counted as
// one funnel shift, + 16 feed-forward adds), 2.44e9 in all, against 160 MB
// written. An SM issues at most 128 such operations per clock (4 schedulers x
// 32 lanes), but the 640 xors and funnel shifts run only on its 64-lane INT
// pipe (the adds can also go to the FMA pipe as IMAD): at least 10 SM clocks
// per block, so at 132 SMs x 1.98 GHz ~0.096 ms of operations against
// ~0.048 ms of HBM writes: the kernel is bound by operations. The rejection test, compaction, mod m and participant
// fold stay torch code around it (ops/chacha_cuda.py); fusing them in is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void quarter(uint32_t& a, uint32_t& b, uint32_t& c,
                                        uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

__global__ void __launch_bounds__(kThreads) chacha20_kernel(
    const uint4* __restrict__ keys, uint64_t first_counter, uint64_t n_blocks,
    uint64_t total, uint4* __restrict__ out) {
  const uint64_t i = (uint64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const uint64_t seed = i / n_blocks;
  const uint64_t counter = first_counter + (i - seed * n_blocks);
  const uint4 k0 = keys[2 * seed];
  const uint4 k1 = keys[2 * seed + 1];

  uint32_t s[16] = {0x61707865u, 0x3320646Eu, 0x79622D32u, 0x6B206574u,
                    k0.x, k0.y, k0.z, k0.w, k1.x, k1.y, k1.z, k1.w,
                    (uint32_t)counter, (uint32_t)(counter >> 32), 0u, 0u};
  uint32_t x[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) x[w] = s[w];

#pragma unroll
  for (int r = 0; r < 10; ++r) {
    quarter(x[0], x[4], x[8], x[12]);
    quarter(x[1], x[5], x[9], x[13]);
    quarter(x[2], x[6], x[10], x[14]);
    quarter(x[3], x[7], x[11], x[15]);
    quarter(x[0], x[5], x[10], x[15]);
    quarter(x[1], x[6], x[11], x[12]);
    quarter(x[2], x[7], x[8], x[13]);
    quarter(x[3], x[4], x[9], x[14]);
  }

  uint4* dst = out + 4 * i;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[q] = make_uint4(x[4 * q] + s[4 * q], x[4 * q + 1] + s[4 * q + 1],
                        x[4 * q + 2] + s[4 * q + 2], x[4 * q + 3] + s[4 * q + 3]);
  }
}

}  // namespace

extern "C" int chacha20_launch(const uint32_t* keys, unsigned long long first_counter,
                               long long n_blocks, long long P, uint32_t* out,
                               void* stream) {
  const uint64_t total = (uint64_t)P * (uint64_t)n_blocks;
  if (total == 0) return 0;
  const uint64_t grid = (total + kThreads - 1) / kThreads;
  chacha20_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const uint4*>(keys), first_counter, (uint64_t)n_blocks, total,
      reinterpret_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}
