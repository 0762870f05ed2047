// Fused per-participant limb share + participant reduction for Hopper (sm_90a),
// on the int8 tensor cores.
//
// Replaces sda_tpu/parallel/limb_pallas.py:participant_limb_sums_pallas.
//
//   in : secrets    (C, d) int32 canonical residues 0 <= x < p < 2^31
//        randomness (C, nb, t) int32 canonical residues (null when t = 0)
//        packed     the (L, L*K, n) int8 stacks of fold_const_limbs as mma B
//                   fragments: (n_tiles, KPS, L, L, 32 lanes, 2) int32
//                   (limb_cuda.pack_stacks)
//   out: (L, nb, n) int32, zeroed by the caller;
//        out[m, b, j] = sum_c sum_{i, kk} limb_i(v[c, b, kk]) * stacks[m, i*K + kk, j]
//        with K = k + t, v[c, b, kk] = secrets[c, b*k + kk] for kk < k (0 where
//        b*k + kk >= d: the zero-padded tail of the batched secrets) and
//        v[c, b, k + r] = randomness[c, b, r].
// The values (C, nb, K) are never built: the old one-tensor form is the case
// t = 0, k = K, d = nb*K.
//
// Bound per chunk at full width (C = 2000, d = 10,000, k = 5, t = 2, n = 8,
// L = 5): 112,321,400 bytes (both inputs read once, stacks, output) -> 33.5 us
// at 3.35 TB/s, against 1.12e10 int8 operations -> 5.7 us at 1,979 TOP/s. The
// function is bound by bytes, so the design streams the inputs and keeps
// everything else on chip:
//
// - Product. Rows are batch rows, 16 per block (one warp). The reduction
//   axis is (participant, kk) with kk zero-padded to Kp = max(4, 2^ceil(log2 K));
//   one mma.sync.m16n8k32 s8 step covers 32/Kp participants (4 at K = 7), or
//   for Kp > 32 one participant's kk slice of 32 (KPS = Kp/32 slices). There is
//   one A operand per input limb i (limb-i bytes of the values, 0..127) and one
//   B operand per (m, i): stacks[m, i*K + kk, clerk], tiled along the
//   participants, zero at kk >= K and clerk >= n. Every per-participant MAC is
//   formed on the tensor cores (this is the per-participant engine; summing
//   limbs over participants first would be the sum-first engine).
// - Registers. The L*L B fragments of the block's clerk tile (50 registers at
//   L = 5) are loaded once (once per slice and stage when KPS > 1); the warp
//   keeps its L accumulators over its whole participant slice.
// - Loads. Each block streams its participant slice for its 16 rows through a
//   3-stage ring in shared memory. Per participant the block's rows are one
//   contiguous run of 16*k secret words and one of 16*t randomness words; one
//   lane moves each run with a TMA bulk copy (cp.async.bulk, 320 and 128
//   bytes at the bench shape) completing on the stage's mbarrier, so the
//   loads cost a few instructions per run. Runs that are not 16-byte aligned,
//   their last words, and the words past d or nb (zero) are written by the
//   lanes; at the bench shape only the last row block has such words. Each
//   participant's chunk ends in a zero word that the padded kk slots read, so
//   the pad is zero on both sides.
// - One warp per block. An earlier form with four warps per block (64 rows)
//   sharing one ring, filled by 16-byte cp.async from every thread, ran 1.7x
//   slower on one H100 (and no faster with TMA): each stage waited for the
//   block's slowest copy under __syncthreads. One-warp blocks with their own
//   rings (14 resident per SM at 140 registers) decouple the warps.
// - Limb split in registers. A thread's four values of one A register are
//   byte-transposed with 8 __byte_perm; limb i of all four is then two shifts
//   and two masks (about 6 INT operations per value with the load).
// - Reduction across blocks. Blocks run in no order, so each adds its int32
//   partial into the output with atomicAdd: exact and order-free, as every
//   partial sum is bounded by C*L*K*127^2 < 2^31, which the wrapper checks.
//   The participant slice per block is chosen so the grid is one resident wave
//   (all SMs, each as full as occupancy allows); at the bench shape that is
//   1,750 blocks of 144 participants, so the atomics (L*16*8 per block, 1.1M)
//   stay small against the 28M values read.
// - n > 8: each tile of 8 clerks is one more block row (blockIdx.y), which
//   reads the values again; the bench has n = 8, one tile.
// mma.sync rather than wgmma: the int8 MACs are a sixth of the bytes time and
// mma.sync on sm_90a has ample rate for them; the rest of the per-value work
// (shared-memory loads, the limb split) runs on the other pipes either way.
// wgmma's 64-row tiles and swizzled shared-memory B buy nothing until the
// loads run at HBM rate.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;     // batch rows per block: one mma row tile
constexpr int kThreads = 32;  // one warp
constexpr int kStages = 3;    // ring depth in shared memory
constexpr int kMaxK = 256;    // the wrapper's limit (3 stages of 16 rows x K words: 49 KB)

struct Shape {
  int C, d, nb, k, t, K, n;
  int Kp;        // padded kk extent: power of two >= 4
  int pps;       // participants per mma step (Kp <= 32), else 1
  int kps;       // kk slices of 32 per participant (Kp > 32), else 1
  int ps;        // participants per stage
  int stride;    // words per participant chunk: 16*K + 4 (ends in a zero word)
  int c_per;     // participants per block slice (a multiple of ps)
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void bar_arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}
// TMA bulk copy global -> shared, completing `bytes` on the stage's mbarrier
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One contiguous run of a participant chunk: `len` words (a multiple of 4) at
// `dst`, of which words 0..valid come from `src` and the rest are zero. The
// leading multiple of 4 words goes by TMA when `src` is 16-byte aligned
// (`bulk` words), every other word by the threads.
struct Run {
  int32_t* dst;
  const int32_t* src;
  int len, valid, bulk;
};

__device__ __forceinline__ Run make_run(int32_t* dst, const int32_t* src, int len, int valid) {
  const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  return Run{dst, src, len, valid, aligned ? (valid & ~3) : 0};
}

// Run r (0 = secrets, 1 = randomness) of participant c's chunk at `chunk`, for
// the block's rows b0 .. b0 + 15; participants at or past c_end are all zero.
__device__ __forceinline__ Run stage_run(int32_t* chunk, const int32_t* __restrict__ secrets,
                                         const int32_t* __restrict__ randomness, const Shape& s,
                                         int c, int c_end, int b0, int r) {
  const bool live = c < c_end;
  if (r == 0) {
    const int len = kRows * s.k;
    return make_run(chunk, secrets + ((size_t)c * s.d + (size_t)b0 * s.k), len,
                    live ? min(len, s.d - b0 * s.k) : 0);
  }
  const int len = kRows * s.t;
  return make_run(chunk + kRows * s.k, randomness + ((size_t)c * s.nb + b0) * s.t, len,
                  live ? min(kRows, s.nb - b0) * s.t : 0);
}

// Start filling one stage buffer with participants c .. c + ps - 1: warp 0's
// lanes issue one TMA copy per run and lane 0 arms the stage's mbarrier with
// their bytes; unless every run is whole and aligned (`full`), all threads
// copy the runs' other words and zero the rest. The TMA part is complete when
// the mbarrier's phase flips; the threads' part after the next __syncthreads.
__device__ __forceinline__ void load_stage(int32_t* buf, uint32_t bar,
                                           const int32_t* __restrict__ secrets,
                                           const int32_t* __restrict__ randomness,
                                           const Shape& s, int c, int c_end, int b0, bool full) {
  const int runs = s.t ? 2 : 1;
  if (threadIdx.x < 32) {
    const int p = threadIdx.x / runs, r = threadIdx.x % runs;
    Run run{};
    if (p < s.ps) run = stage_run(buf + p * s.stride, secrets, randomness, s, c + p, c_end, b0, r);
    const uint32_t bytes = 4u * run.bulk;
    const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
    if (threadIdx.x == 0) bar_arrive_expect(bar, total);
    __syncwarp();
    if (bytes) bulk_copy(smem_addr(run.dst), run.src, bytes, bar);
  }
  if (full) return;
  for (int p = 0; p < s.ps; ++p)
    for (int r = 0; r < runs; ++r) {
      const Run run = stage_run(buf + p * s.stride, secrets, randomness, s, c + p, c_end, b0, r);
      for (int w = run.bulk + threadIdx.x; w < run.len; w += kThreads)
        run.dst[w] = w < run.valid ? run.src[w] : 0;
    }
  // order these generic writes before later TMA writes into the same buffer
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes e of the result are byte j of x_e: a 4x4 byte transpose
__device__ __forceinline__ void transpose4(const int x[4], uint32_t B[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140), t1 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362), t3 = __byte_perm(x[2], x[3], 0x7362);
  B[0] = __byte_perm(t0, t1, 0x5410);
  B[1] = __byte_perm(t0, t1, 0x7632);
  B[2] = __byte_perm(t2, t3, 0x5410);
  B[3] = __byte_perm(t2, t3, 0x7632);
}

// limb i (bits 7i .. 7i+6) of the four values whose bytes B holds transposed
__device__ __forceinline__ uint32_t limb_word(const uint32_t B[4], int i) {
  switch (i) {
    case 0: return B[0] & 0x7F7F7F7Fu;
    case 1: return ((B[0] >> 7) & 0x01010101u) | ((B[1] << 1) & 0x7E7E7E7Eu);
    case 2: return ((B[1] >> 6) & 0x03030303u) | ((B[2] << 2) & 0x7C7C7C7Cu);
    case 3: return ((B[2] >> 5) & 0x07070707u) | ((B[3] << 3) & 0x78787878u);
    default: return (B[3] >> 4) & 0x0F0F0F0Fu;  // x < 2^31: bit 31 is 0
  }
}

__device__ __forceinline__ void mma_s8(int c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <int L>
__global__ void __launch_bounds__(kThreads) limb_share_sum_kernel(
    const int32_t* __restrict__ secrets, const int32_t* __restrict__ randomness,
    const int2* __restrict__ packed, int32_t* __restrict__ out, Shape s) {
  extern __shared__ __align__(16) int32_t smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int b0 = blockIdx.x * kRows, tile = blockIdx.y;
  const int c0 = blockIdx.z * s.c_per;
  const int c_end = min(s.C, c0 + s.c_per);
  const int n_stages = (c_end - c0 + s.ps - 1) / s.ps;
  const int stage_words = s.ps * s.stride;
  const int zero_word = kRows * s.K;
  __shared__ __align__(8) uint64_t bars[kStages];

  // the zero word that ends every participant chunk of every stage
  for (int p = threadIdx.x; p < kStages * s.ps; p += kThreads) smem[p * s.stride + zero_word] = 0;
  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) bar_init(smem_addr(&bars[st]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // every run of a stage whole and 16-byte aligned: the TMA moves it all
  const bool whole_rows = b0 + kRows <= s.nb && (b0 + kRows) * s.k <= s.d;
  const bool aligned = (reinterpret_cast<uintptr_t>(secrets) & 15) == 0 && s.d % 4 == 0 &&
                       (s.t == 0 || ((reinterpret_cast<uintptr_t>(randomness) & 15) == 0 &&
                                     (s.nb * s.t) % 4 == 0));
  auto stage_full = [&](int st) { return whole_rows && aligned && c0 + (st + 1) * s.ps <= c_end; };

  // this thread's A slots: register h covers reduction slots 16h + 4q + e
  int pofs[2], kk0[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = 16 * h + 4 * q;
    pofs[h] = s.Kp <= 32 ? slot / s.Kp : 0;
    kk0[h] = s.Kp <= 32 ? slot % s.Kp : slot;
  }
  const int row[2] = {16 * warp + g, 16 * warp + g + 8};

  int acc[L][4];
#pragma unroll
  for (int m = 0; m < L; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[m][r] = 0;

  for (int st = 0; st < kStages - 1 && st < n_stages; ++st)
    load_stage(smem + st * stage_words, smem_addr(&bars[st]), secrets, randomness, s,
               c0 + st * s.ps, c_end, b0, stage_full(st));

  uint32_t bfrag[L][L][2];
  int off[2][2][4];  // [h][row half][e]: word offset within a participant chunk
  const int steps = s.ps / s.pps;  // mma steps per kk slice of a stage
  for (int st = 0; st < n_stages; ++st) {
    bar_wait(smem_addr(&bars[st % kStages]), (st / kStages) & 1);  // stage st's TMA part
    __syncthreads();  // its thread-copied words too; stage st-1's buffer is free
    {
      const int next = st + kStages - 1;
      if (next < n_stages)
        load_stage(smem + (next % kStages) * stage_words, smem_addr(&bars[next % kStages]),
                   secrets, randomness, s, c0 + next * s.ps, c_end, b0, stage_full(next));
    }
    const int32_t* buf = smem + (st % kStages) * stage_words;
    for (int sl = 0; sl < s.kps; ++sl) {
      if (st == 0 || s.kps > 1) {
        const int2* src = packed + (size_t)(tile * s.kps + sl) * L * L * 32 + lane;
#pragma unroll
        for (int m = 0; m < L; ++m)
#pragma unroll
          for (int i = 0; i < L; ++i) {
            const int2 w = src[(m * L + i) * 32];
            bfrag[m][i][0] = static_cast<uint32_t>(w.x);
            bfrag[m][i][1] = static_cast<uint32_t>(w.y);
          }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int kk = kk0[h] + 32 * sl + e;
              off[h][r][e] = kk < s.k   ? row[r] * s.k + kk
                             : kk < s.K ? kRows * s.k + row[r] * s.t + (kk - s.k)
                                        : zero_word;
            }
      }
      for (int j = 0; j < steps; ++j) {
        uint32_t B[2][2][4];  // [h][row half]: the four values, bytes transposed
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int32_t* chunk = buf + (j * s.pps + pofs[h]) * s.stride;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            int x[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) x[e] = chunk[off[h][r][e]];
            transpose4(x, B[h][r]);
          }
        }
#pragma unroll
        for (int i = 0; i < L; ++i) {
          // A registers: (row g, slots 4q..), (row g+8, 4q..), (g, 16+4q..), (g+8, 16+4q..)
          const uint32_t a[4] = {limb_word(B[0][0], i), limb_word(B[0][1], i),
                                 limb_word(B[1][0], i), limb_word(B[1][1], i)};
#pragma unroll
          for (int m = 0; m < L; ++m) mma_s8(acc[m], a, bfrag[m][i]);
        }
      }
    }
  }

  // D fragment: rows g (regs 0, 1) and g + 8 (regs 2, 3), clerks 2q, 2q + 1
  const int j0 = tile * 8 + 2 * q;
#pragma unroll
  for (int m = 0; m < L; ++m)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b = b0 + row[r >> 1], j = j0 + (r & 1);
      if (b < s.nb && j < s.n) atomicAdd(&out[((size_t)m * s.nb + b) * s.n + j], acc[m][r]);
    }
}

template <int L>
int launch(const int32_t* secrets, const int32_t* randomness, const int32_t* packed,
           int32_t* out, Shape s, cudaStream_t stream) {
  const int smem = kStages * s.ps * s.stride * static_cast<int>(sizeof(int32_t));
  auto kernel = limb_share_sum_kernel<L>;
  // resident blocks per SM for this shared-memory size, asked once per size
  // and device (the launch is on the hot path: 50 per streamed round)
  static int cached_device = -1, cached_smem = -1, sms = 0, per_sm = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device != cached_device || smem != cached_smem) {
    if (smem > 48 * 1024 &&
        (err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
            cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
      return static_cast<int>(err);
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
        cudaSuccess)
      return static_cast<int>(err);
    cached_device = device, cached_smem = smem;
  }
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  // one resident wave: split the participants so the grid fills every SM
  const int row_blocks = (s.nb + kRows - 1) / kRows, tiles = (s.n + 7) / 8;
  const int slices = max(1, sms * per_sm / (row_blocks * tiles));
  s.c_per = (s.C + slices - 1) / slices;
  s.c_per = (s.c_per + s.ps - 1) / s.ps * s.ps;
  const dim3 grid(row_blocks, tiles, (s.C + s.c_per - 1) / s.c_per);
  kernel<<<grid, kThreads, smem, stream>>>(secrets, randomness,
                                           reinterpret_cast<const int2*>(packed), out, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// secrets (C, d), randomness (C, nb, t) or null when t = 0, packed B
// fragments, out (L, nb, n) zeroed. Returns a cudaError_t (0 on success).
extern "C" int limb_share_sum_launch(const int32_t* secrets, const int32_t* randomness,
                                     const int32_t* packed, int32_t* out, int C, int d,
                                     int nb, int k, int t, int L, int n, void* stream) {
  Shape s{};
  s.C = C, s.d = d, s.nb = nb, s.k = k, s.t = t, s.K = k + t, s.n = n;
  if (C <= 0 || nb <= 0 || n <= 0 || k <= 0 || t < 0 || s.K > kMaxK ||
      (long long)nb * k < d || (long long)(nb - 1) * k >= d || (t > 0 && !randomness))
    return static_cast<int>(cudaErrorInvalidValue);
  s.Kp = 4;
  while (s.Kp < s.K) s.Kp *= 2;
  s.pps = s.Kp <= 32 ? 32 / s.Kp : 1;
  s.kps = s.Kp <= 32 ? 1 : s.Kp / 32;
  s.ps = s.Kp <= 32 ? 2 * s.pps : 1;
  s.stride = kRows * s.K + 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (L) {
    case 1: return launch<1>(secrets, randomness, packed, out, s, st);
    case 2: return launch<2>(secrets, randomness, packed, out, s, st);
    case 3: return launch<3>(secrets, randomness, packed, out, s, st);
    case 4: return launch<4>(secrets, randomness, packed, out, s, st);
    case 5: return launch<5>(secrets, randomness, packed, out, s, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
