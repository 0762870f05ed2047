// The discrete Gaussian sampler for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package draws its DP noise on the host with
// numpy (sda_tpu/models/dp.py sample_discrete_gaussian). The port's sampler
// (sda_tpu_torch/models/dp.py _dgauss_pass) ran it as torch passes: a
// float64 geometric pair and a uniform for a pooled budget of proposals, the
// acceptance test as separate elementwise passes, then a boolean index that
// kept the accepted proposals in order and synced the host on their count.
// This kernel does the same mathematics in one launch, with no compaction
// pass and no host sync.
//
//   in : key, one u64 in device memory (drawn from the caller's generator);
//        n; t = floor(sigma) + 1; center = sigma^2 / t;
//        scale = -1 / (2 sigma^2), all three computed on the host in float64
//   out: out (n,) int64, i.i.d. draws of N_Z(0, sigma^2);
//        *proposals += the proposals this launch drew (one atomicAdd a block)
//
// The law (Canonne, Kamath and Steinke 2020, Algorithm 3). A proposal is one
// Philox4x32-10 call (Salmon et al. 2011, the generator class of torch's CUDA
// generator) of key `key` at counter (32 step + lane as a u64, segment as a
// u64): its 128 bits give a = w0 << 21 | w1 >> 11 and b = w2 << 21 | w3 >> 11
// (53 bits each) and the sign bit w1 & 1. G = floor(-t log((a + 1) 2^-53)) is
// geometric with P(G >= k) = exp(-k / t); Y = -G where the sign bit is set,
// else G, with (-, 0) rejected, is discrete Laplace with scale t. Y is
// accepted where b 2^-53 < exp((G - center)^2 scale), all in float64 (the
// products rounded one by one, never fused). The plain twin,
// sda_tpu_torch/ops/dgauss_cuda.py dgauss_plain, does the same arithmetic in
// torch, and the card tests hold the two equal bit for bit.
//
// The segment fill. A warp owns segments of kSegment output values
// (grid-stride over them). Each step, every lane draws one proposal and
// tests it in registers; the step's accepted proposals take the segment's
// next slots in lane order (ballot and popc), and steps go on until the
// segment is full, the surplus of the last step discarded. The kept values
// are the first kSegment accepted proposals of an i.i.d. sequence, so they
// are i.i.d. N_Z(0, sigma^2), and no pass compacts them and no count goes to
// the host. The cost is the last step's surplus: at sigma >> 1 about 1.38
// proposals a value against the 1.32 that an unbounded pool would draw.
//
// Bound. No input is read; each value writes 8 bytes, and each proposal costs
// Philox's 10 rounds (4 32-bit multiplies, 2 three-way xors and 2 key adds a
// round), one float64 log and, past the sign test, one float64 exp. So the
// kernel is bound by the INT and FP64 pipes, not by the HBM: at the DP cell's
// chunk (25 x 4,050,748 values, sigma 6,654.23) 1.39e8 proposals against 0.81
// GB written (0.24 ms at 3.35 TB/s). It takes 1.35 ms there on an H100 SXM at
// 700 W (53 registers, 4 blocks of 8 warps an SM), against 11.5 ms for the
// torch passes it replaces.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;
constexpr int kSegment = 256;  // values a warp fills in one go; a multiple of kLanes
constexpr int kWarps = 8;      // warps a block
constexpr int kThreads = kWarps * kLanes;

// Philox4x32-10 (Random123's philox4x32_R with R = 10): c is the counter on
// entry and the four output words on return.
__device__ __forceinline__ void philox(uint32_t k0, uint32_t k1, uint32_t c[4]) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    const uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

__global__ void __launch_bounds__(kThreads) dgauss_kernel(
    const unsigned long long* __restrict__ key, long long n, long long segments, double t,
    double center, double scale, long long* __restrict__ out,
    unsigned long long* __restrict__ proposals) {
  __shared__ unsigned long long block_steps;
  if (threadIdx.x == 0) block_steps = 0;
  __syncthreads();
  const int lane = threadIdx.x & (kLanes - 1);
  const unsigned int below = (1u << lane) - 1u;
  const unsigned long long k = *key;
  const uint32_t k0 = (uint32_t)k, k1 = (uint32_t)(k >> 32);
  const long long warps = (long long)gridDim.x * kWarps;
  unsigned long long steps = 0;  // the same in every lane of a warp

  for (long long seg = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); seg < segments;
       seg += warps) {
    const long long base = seg * kSegment;
    const int len = n - base < kSegment ? (int)(n - base) : kSegment;
    int filled = 0;
    for (unsigned long long step = 0; filled < len; ++step) {
      const unsigned long long offset = step * kLanes + lane;
      uint32_t c[4] = {(uint32_t)offset, (uint32_t)(offset >> 32), (uint32_t)seg,
                       (uint32_t)((unsigned long long)seg >> 32)};
      philox(k0, k1, c);
      const uint64_t a = ((uint64_t)c[0] << 21) | (c[1] >> 11);
      const uint64_t b = ((uint64_t)c[2] << 21) | (c[3] >> 11);
      const bool negative = c[1] & 1u;
      // (a + 1) 2^-53 lies in (0, 1] and is exact in float64, as is b 2^-53
      const double g = floor(__dmul_rn(log((double)(a + 1) * 0x1p-53), -t));
      const double dev = __dsub_rn(g, center);
      const bool ok = !(negative && g == 0.0) &&
                      (double)b * 0x1p-53 < exp(__dmul_rn(__dmul_rn(dev, dev), scale));
      const unsigned int accepted = __ballot_sync(0xFFFFFFFFu, ok);
      const int slot = filled + __popc(accepted & below);
      if (ok && slot < len) out[base + slot] = negative ? -(long long)g : (long long)g;
      filled += __popc(accepted);
      ++steps;
    }
  }

  if (lane == 0 && steps) atomicAdd(&block_steps, steps);
  __syncthreads();
  if (threadIdx.x == 0 && block_steps) atomicAdd(proposals, block_steps * kLanes);
}

}  // namespace

extern "C" int dgauss_launch(const unsigned long long* key, long long n, double t, double center,
                             double scale, long long* out, unsigned long long* proposals,
                             void* stream) {
  if (n <= 0) return 0;
  // a grid of the blocks that fit the card at once; each warp strides over
  // the segments
  static int resident = 0;
  if (!resident) {
    int device = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dgauss_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    resident = sms * per_sm;
  }
  const long long segments = (n + kSegment - 1) / kSegment;
  const long long wanted = (segments + kWarps - 1) / kWarps;
  const int grid = wanted < resident ? (int)wanted : resident;
  dgauss_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      key, n, segments, t, center, scale, out, proposals);
  return static_cast<int>(cudaGetLastError());
}
