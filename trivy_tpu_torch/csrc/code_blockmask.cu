// Literal-code blockmask kernel for Hopper (sm_90a).
//
// Replaces trivy_tpu/ops/keywords_pallas.py::code_blockmask_pallas
// (body _kernel): per segment row of L bytes and per code k (a literal
// of at most 8 bytes, packed as two little-endian words and two masks),
// code k hits at position p when the ASCII-lowercased 8-byte window at
// p passes (lo & lo_mask[k]) == lo[k] and (hi & hi_mask[k]) == hi[k];
// out[row, k] holds bit p / (L/16) for every hit p. Bytes past L read
// as 0. Every column is computed, pad codes (0 under full masks, which
// hit 8-NUL windows) included: the callers slice them off.
//
// What bounds it on an H100. Reading a 2048-byte row costs nothing
// next to the compares: the builtin table's 128 codes take ~496
// integer operations per position as chip_smoke.py counts them (a
// masked compare per non-empty half word, their AND, one OR into the
// block bit; lowering and one funnel shift per position). A batch of
// 40,960 rows moves ~105 MB (~0.03 ms at 3.35 TB/s) but does ~4.2e10
// integer operations (~2.5 ms at the INT32 rate of 16.7 T/s): the
// kernel is bound by integer ALU issue, not by memory.
//
// What the design does about it. The lowered row is staged once into
// shared memory with zero bytes past L. Each thread owns 8 consecutive
// positions (all in one block, since L/16 is a multiple of 8) and
// builds their 12 window words ONCE per row in registers; every code's
// four words are then a uniform (broadcast) shared-memory read, so the
// inner loop is only the compares. Per code, a warp votes, OR-reduces
// its lanes' block bits only when something hit (a warp may span
// several blocks when L is small: each lane brings its own bit), and
// one lane ORs the result into the row's mask with a shared atomic;
// misses, nearly all (position, code) pairs, cost no memory traffic.
// One store per (row, code) writes the masks out. The TPU kernel's
// block reduction on the matrix unit has no counterpart here.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int POS = 8;            // positions per thread per pass
constexpr int PAD = 16;           // zero bytes kept past the row end
constexpr int N_BLOCKS = 16;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ uint32_t lower4(uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t b = (v >> (8 * i)) & 0xffu;
    if (b - 65u <= 25u) b += 32u;
    r |= b << (8 * i);
  }
  return r;
}

__global__ void __launch_bounds__(THREADS)
code_blockmask_kernel(const uint8_t* __restrict__ seg, int B, int L,
                      const uint32_t* __restrict__ gcodes, int K,
                      uint32_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  uint32_t* codes = smem;                     // lo | hi | lo_mask | hi_mask
  uint32_t* smask = codes + 4 * K;            // [K] this row's masks
  uint32_t* low = smask + ((K + 3) & ~3);     // lowered row, then PAD zeros
  const int tid = threadIdx.x;
  const int row_words = (L + PAD) / 4;

  for (int i = tid; i < 4 * K; i += THREADS) codes[i] = gcodes[i];
  // the zero tail past L is written once and never overwritten
  for (int i = L / 4 + tid; i < row_words; i += THREADS) low[i] = 0u;

  const int blk = L / N_BLOCKS;
  const int n_pass = (L / POS + THREADS - 1) / THREADS;

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(seg + static_cast<size_t>(row) * L);
    for (int i = tid; i < L / 16; i += THREADS) {
      const uint4 v = src[i];
      low[4 * i] = lower4(v.x);
      low[4 * i + 1] = lower4(v.y);
      low[4 * i + 2] = lower4(v.z);
      low[4 * i + 3] = lower4(v.w);
    }
    for (int i = tid; i < K; i += THREADS) smask[i] = 0u;
    __syncthreads();

    // every lane of a warp runs every pass and every code (warp votes)
    for (int pass = 0; pass < n_pass; ++pass) {
      const int base = (pass * THREADS + tid) * POS;
      const bool valid = base < L;
      const uint32_t bbit = valid ? (1u << (base / blk)) : 0u;
      uint32_t w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) w[i] = valid ? low[(base >> 2) + i] : 0u;
      // q[j]: the word of the lowered bytes at base+j .. base+j+3
      uint32_t q[POS + 4];
#pragma unroll
      for (int j = 0; j < POS + 4; ++j)
        q[j] = __funnelshift_r(w[j >> 2], w[(j >> 2) + 1], 8 * (j & 3));

      for (int k = 0; k < K; ++k) {
        const uint32_t klo = codes[k], khi = codes[K + k];
        const uint32_t mlo = codes[2 * K + k], mhi = codes[3 * K + k];
        bool any = false;
#pragma unroll
        for (int i = 0; i < POS; ++i)
          any |= ((q[i] & mlo) == klo) & ((q[i + 4] & mhi) == khi);
        any = any && valid;
        if (__any_sync(FULL, any)) {
          const uint32_t v = __reduce_or_sync(FULL, any ? bbit : 0u);
          if ((tid & 31) == 0) atomicOr(smask + k, v);
        }
      }
    }
    __syncthreads();
    for (int i = tid; i < K; i += THREADS)
      out[static_cast<size_t>(row) * K + i] = smask[i];
    __syncthreads();
  }
}

// Resident CTAs the card holds at this shared-memory size, found once
// per (device, smem): the attribute and occupancy queries stay off the
// launch path after the first call.
cudaError_t resident_ctas(size_t smem, int* ctas) {
  static std::mutex mu;
  static std::map<std::pair<int, size_t>, int> cache;
  static std::map<int, size_t> smem_allowed;   // the attribute, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_pair(dev, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *ctas = it->second;
    return cudaSuccess;
  }
  // the attribute is one value per function and device: only ever
  // raise it, so every size cached before stays launchable
  if (smem > smem_allowed[dev]) {
    err = cudaFuncSetAttribute(code_blockmask_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, code_blockmask_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  *ctas = cache[key] = sms * (per_sm < 1 ? 1 : per_sm);
  return cudaSuccess;
}

}  // namespace

// segments [B, L] uint8 (L % 128 == 0, 16-byte aligned rows), codes
// uint32[4 K] (lo | hi | lo_mask | hi_mask), out [B, K] uint32.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int code_blockmask_launch(const void* seg, int B, int L,
                                     const void* codes, int K, void* out,
                                     void* stream) {
  const size_t smem = 4 * (4 * static_cast<size_t>(K) + ((K + 3) & ~3) +
                           (L + PAD) / 4);
  int ctas = 0;
  const cudaError_t err = resident_ctas(smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < ctas ? B : ctas;
  code_blockmask_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), B, L, static_cast<const uint32_t*>(codes),
      K, static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
