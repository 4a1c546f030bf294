// DFA blockmask kernel for Hopper (sm_90a).
//
// Replaces trivy_tpu/ops/dfa_pallas.py::dfa_blockmask_pallas (body
// _make_kernel): per segment row of L bytes, every pattern of the
// compiled secret table is tested at every position, and each
// pattern's hits are reduced to a 16-bit mask over 16 blocks of L/16
// bytes.
//   - a literal of c 8-byte chunks hits at t when, for every chunk j,
//     the lowered window words at t+8j pass (word & mask) == code;
//   - a chain ANDs its units, each moved to the chain END: a "lit"
//     unit is the literal test on LOWERED bytes, a "run" unit is n
//     consecutive RAW bytes in a set of byte ranges;
//   - bytes past L read as 0 (window words), are never members of a
//     range set (runs), and a chain start before 0 never hits.
// The chain structure is data: a flat int32 descriptor (see
// ops/dfa.py DfaTable.kernel_desc) that one binary reads for every
// rule set.
//
// What bounds it on an H100. Reading a 2048-byte row costs nothing
// next to the compares: the builtin table has 144 literals in 166
// 8-byte chunks, and each (position, chunk) is two masked 32-bit
// compares and their AND. Counted as chip_smoke.py counts them (chain
// units only where the data needs them, compares under a 0 mask
// dropped), the builtin table needs ~750 integer operations per input
// byte. A batch of 40,960 rows moves ~84 MB (~25 us at 3.35 TB/s) but
// does ~6.3e10 integer operations (~3.8 ms at the INT32 rate of
// 16.7 T/s): the kernel is bound by integer ALU issue, not by memory.
//
// What the design does about it. The row is staged once into shared
// memory, raw and lowered. Each thread owns 8 consecutive positions
// and builds their window words ONCE in registers; every literal's
// words are then a uniform (broadcast) shared-memory read, so the
// inner loop is only the compares. A warp reduces its hits to block
// bits with one vote (and an OR-reduction only when something hit)
// and one shared atomic per hit pattern, so misses — nearly all
// (position, pattern) pairs — cost no memory traffic. Range-set
// membership is computed once per row into shared bitmaps, so a run
// unit of up to 48 bytes is one 64-bit window test per position.

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int POS = 8;            // positions per thread per pass
constexpr int PAD = 64;           // zero bytes kept past the row end
constexpr int N_BLOCKS = 16;
constexpr int SET_INTS = 17;      // n_ranges + 8 (lo, hi) pairs
constexpr int UNIT_LIT = 0;
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

// 32-bit little-endian word of the bytes at t..t+3
__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int t) {
  return __funnelshift_r(w[t >> 2], w[(t >> 2) + 1], 8 * (t & 3));
}

// OR one thread's block bit into a pattern's mask, once per warp
__device__ __forceinline__ void record(bool hit, uint32_t bbit,
                                       uint32_t* slot) {
  if (__any_sync(FULL, hit)) {
    uint32_t v = __reduce_or_sync(FULL, hit ? bbit : 0u);
    if ((threadIdx.x & 31) == 0) atomicOr(slot, v);
  }
}

// One literal group of C chunks: `count` literals, each 4*C words
// (lo, hi, lo_mask, hi_mask per chunk), columns col0..col0+count-1.
template <int C>
__device__ __forceinline__ void lit_group(
    const uint32_t* low, int base, bool valid, uint32_t bbit,
    const uint32_t* words, int count, int col0, uint32_t* smask) {
  constexpr int NW = 2 * C + 2;   // aligned words covering the windows
  constexpr int NQ = 8 * C + 4;   // window words at base+0 .. base+8C+3
  uint32_t w[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = valid ? low[(base >> 2) + i] : 0u;
  uint32_t q[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i)
    q[i] = __funnelshift_r(w[i >> 2], w[(i >> 2) + 1], 8 * (i & 3));
  for (int k = 0; k < count; ++k) {
    const uint32_t* kw = words + 4 * C * k;
    uint32_t klo[C], khi[C], mlo[C], mhi[C];
#pragma unroll
    for (int j = 0; j < C; ++j) {
      klo[j] = kw[4 * j];
      khi[j] = kw[4 * j + 1];
      mlo[j] = kw[4 * j + 2];
      mhi[j] = kw[4 * j + 3];
    }
    bool any = false;
#pragma unroll
    for (int i = 0; i < POS; ++i) {
      bool h = true;
#pragma unroll
      for (int j = 0; j < C; ++j)
        h &= ((q[i + 8 * j] & mlo[j]) == klo[j]) &
             ((q[i + 8 * j + 4] & mhi[j]) == khi[j]);
      any |= h;
    }
    record(any && valid, bbit, smask + col0 + k);
  }
}

__device__ __forceinline__ bool lit_at(const uint32_t* low, int s,
                                       const uint32_t* kw, int chunks) {
  bool ok = true;
  for (int j = 0; j < chunks; ++j, kw += 4) {
    const int t = s + 8 * j;
    ok &= ((word_at(low, t) & kw[2]) == kw[0]) &
          ((word_at(low, t + 4) & kw[3]) == kw[1]);
  }
  return ok;
}

// positions s..s+n-1 (n <= 48) all set in a membership bitmap
__device__ __forceinline__ bool run_at(const uint32_t* bm, int s, int n) {
  const int w = s >> 5, sh = s & 31;
  uint64_t x = ((static_cast<uint64_t>(bm[w + 1]) << 32) | bm[w]) >> sh;
  if (sh) x |= static_cast<uint64_t>(bm[w + 2]) << (64 - sh);
  const uint64_t need = (1ull << n) - 1ull;
  return (x & need) == need;
}

__global__ void __launch_bounds__(THREADS)
dfa_blockmask_kernel(const uint8_t* __restrict__ seg, int B, int L,
                     const int32_t* __restrict__ gdesc, int desc_len,
                     int n_patterns, int n_sets,
                     uint16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* desc = reinterpret_cast<int32_t*>(smem);
  uint32_t* smask = reinterpret_cast<uint32_t*>(desc + ((desc_len + 3) & ~3));
  const int row_words = (L + PAD) / 4;
  uint32_t* raw = smask + ((n_patterns + 3) & ~3);
  uint32_t* low = raw + row_words;
  uint32_t* bm = low + row_words;
  const int bmw = L / 32 + 4;     // bitmap words per range set
  const uint8_t* rawb = reinterpret_cast<const uint8_t*>(raw);
  uint8_t* bmb = reinterpret_cast<uint8_t*>(bm);
  const int tid = threadIdx.x;

  for (int i = tid; i < desc_len; i += THREADS) desc[i] = gdesc[i];
  // the zero tails past L are written once and never overwritten
  for (int i = L / 4 + tid; i < row_words; i += THREADS) raw[i] = low[i] = 0u;
  for (int i = tid; i < n_sets * bmw; i += THREADS) bm[i] = 0u;
  __syncthreads();

  const int n_groups = desc[0], n_chains = desc[1];
  const int32_t* groups = desc + desc[4];
  const int32_t* chains = desc + desc[5];
  const int32_t* sets = desc + desc[7];
  const uint32_t* words = reinterpret_cast<const uint32_t*>(desc);
  const int blk = L / N_BLOCKS;
  const int n_pass = (L / POS + THREADS - 1) / THREADS;

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(seg + static_cast<size_t>(row) * L);
    for (int i = tid; i < L / 16; i += THREADS) {
      const uint4 v = src[i];
      raw[4 * i] = v.x; raw[4 * i + 1] = v.y;
      raw[4 * i + 2] = v.z; raw[4 * i + 3] = v.w;
      low[4 * i] = lower4(v.x); low[4 * i + 1] = lower4(v.y);
      low[4 * i + 2] = lower4(v.z); low[4 * i + 3] = lower4(v.w);
    }
    for (int i = tid; i < n_patterns; i += THREADS) smask[i] = 0u;
    __syncthreads();

    // range-set membership of the raw bytes, one bit per position
    for (int base = tid * POS; base < L; base += THREADS * POS) {
      for (int s = 0; s < n_sets; ++s) {
        const int32_t* sd = sets + SET_INTS * s;
        uint32_t bits = 0;
        for (int i = 0; i < POS; ++i) {
          const uint32_t b = rawb[base + i];
          bool m = false;
          for (int r = 0; r < sd[0]; ++r)
            m |= b - static_cast<uint32_t>(sd[1 + 2 * r]) <=
                 static_cast<uint32_t>(sd[2 + 2 * r] - sd[1 + 2 * r]);
          bits |= static_cast<uint32_t>(m) << i;
        }
        bmb[4 * bmw * s + (base >> 3)] = static_cast<uint8_t>(bits);
      }
    }
    __syncthreads();

    // every lane of a warp runs every pass (record() votes warp-wide)
    for (int pass = 0; pass < n_pass; ++pass) {
      const int base = (pass * THREADS + tid) * POS;
      const bool valid = base < L;
      const uint32_t bbit = valid ? (1u << (base / blk)) : 0u;

      for (int g = 0; g < n_groups; ++g) {
        const int32_t* gd = groups + 4 * g;
        const uint32_t* gw = words + gd[3];
        switch (gd[0]) {
          case 1: lit_group<1>(low, base, valid, bbit, gw, gd[2], gd[1], smask); break;
          case 2: lit_group<2>(low, base, valid, bbit, gw, gd[2], gd[1], smask); break;
          case 3: lit_group<3>(low, base, valid, bbit, gw, gd[2], gd[1], smask); break;
          default: lit_group<4>(low, base, valid, bbit, gw, gd[2], gd[1], smask); break;
        }
      }

      for (int c = 0; c < n_chains; ++c) {
        const int32_t* cd = chains + 4 * c;
        const int K = cd[1], n_units = cd[2];
        const int32_t* ud = desc + cd[3];
        uint32_t acc = valid ? 0xffu : 0u;   // bit i: END at base+i
        for (int u = 0; u < n_units && acc; ++u, ud += 4) {
          const int d = K - 1 - ud[1];       // start = end - d
          uint32_t pm = 0;
          for (int i = 0; i < POS; ++i) {
            const int s = base + i - d;
            if (s < 0 || !((acc >> i) & 1u)) continue;
            const bool p = ud[0] == UNIT_LIT
                ? lit_at(low, s, words + ud[3], (ud[2] + 7) >> 3)
                : run_at(bm + bmw * ud[3], s, ud[2]);
            pm |= static_cast<uint32_t>(p) << i;
          }
          acc &= pm;
        }
        record(acc != 0u, bbit, smask + cd[0]);
      }
    }
    __syncthreads();
    for (int i = tid; i < n_patterns; i += THREADS)
      out[static_cast<size_t>(row) * n_patterns + i] = static_cast<uint16_t>(smask[i]);
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
    err = cudaFuncSetAttribute(dfa_blockmask_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    smem_allowed[dev] = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dfa_blockmask_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  *ctas = cache[key] = sms * (per_sm < 1 ? 1 : per_sm);
  return cudaSuccess;
}

}  // namespace

// segments [B, L] uint8 (L % 128 == 0, 16-byte aligned rows), desc
// int32[desc_len], out [B, n_patterns] uint16. Launches on `stream`
// and returns cudaGetLastError() (0 on success).
extern "C" int dfa_blockmask_launch(const void* seg, int B, int L,
                                    const void* desc, int desc_len,
                                    int n_patterns, int n_sets,
                                    void* out, void* stream) {
  const size_t smem = 4 * (static_cast<size_t>((desc_len + 3) & ~3) +
                           ((n_patterns + 3) & ~3) + 2 * ((L + PAD) / 4) +
                           static_cast<size_t>(n_sets) * (L / 32 + 4));
  int ctas = 0;
  const cudaError_t err = resident_ctas(smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < ctas ? B : ctas;
  dfa_blockmask_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), B, L, static_cast<const int32_t*>(desc),
      desc_len, n_patterns, n_sets, static_cast<uint16_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
