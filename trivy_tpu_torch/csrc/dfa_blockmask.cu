// DFA blockmask kernel for Hopper (sm_90a), with the class-run gate
// fused into the same launch.
//
// Replaces trivy_tpu/ops/dfa_pallas.py::dfa_blockmask_pallas (body
// _make_kernel) and, in the same launch, trivy_tpu/ops/runs.py::
// run_hits_impl (which the reference jits beside it, ops/dfa.py
// _build_sieve). Per segment row of L bytes:
//   - a literal of C 8-byte chunks hits at t when, for every chunk j,
//     the lowered window words at t+8j pass (word & mask) == code; its
//     column holds bit t / (L/16) for every hit t (START blocks);
//   - a chain ANDs its units, each moved to the chain END: a "lit"
//     unit is the literal test on LOWERED bytes, a "run" unit is n
//     consecutive RAW bytes in a byte set; its column holds END blocks;
//   - a run spec (set, n) hits the row when n consecutive raw bytes
//     lie in its set (hits[row, spec], 0 or 1);
//   - bytes past L read as 0 (window words), are never members of a
//     set, and a chain start before 0 never hits.
// The table is data: a flat int32 descriptor (ops/dfa.py
// DfaTable.kernel_desc) that one binary reads for every rule set.
//
// What bounds it on an H100. Reading a 2048-byte row costs nothing
// next to the compares: the builtin table has 144 literals, and
// chip_smoke.py counts ~750 integer operations per input byte (most of
// them the literals' masked compares). A batch of 40,960 rows moves
// ~84 MB (~25 us at 3.35 TB/s) but does ~6e10 integer operations
// (~3.8 ms at the INT32 rate of 16.7 T/s): the kernel is bound by
// integer ALU issue, not by memory.
//
// What the design does about it.
//   - Literals are brute force in registers. The row is staged once in
//     shared memory, raw and lowered. Each thread owns POS consecutive
//     positions (16 where L/16 is a multiple of 16, else 8) and builds
//     their window words once per pass; every literal's chunk is then
//     one uniform 128-bit shared load. The descriptor groups literals
//     by mask shape (chunk count x last-chunk masks), and a templated
//     loop per shape tests a position as XORs folded with ORs into one
//     word that is zero on a hit: no AND under a full mask, no compare
//     under a zero mask. A warp reduces a literal's hits to block bits
//     with one vote (and an OR-reduction and a shared atomic only when
//     something hit), so misses cost no memory traffic.
//   - Sets are one class-table lookup per byte. A 256-entry table in
//     shared memory holds one bit per distinct set (chain run units and
//     run specs, deduplicated, any number of sets); a warp turns 32
//     bytes into one bitmap word per set with a ballot.
//   - Chains are bit-parallel, as in the TPU kernel: a lit unit is
//     tested like a literal and stored as a START bitmap, a run unit is
//     its set's bitmap eroded by n (log-doubling with funnel shifts,
//     each distinct (set, n) once per row, shared by chains and run
//     specs), and a chain is the AND of its unit bitmaps, each shifted
//     to the chain END, over L/32 words. Nothing is interpreted per
//     position.
//   - Run hits are an OR over the spec's eroded bitmap, in the same
//     launch: the class-run gate costs one more bitmap per spec set.

#include <cstdint>
#include <map>
#include <mutex>
#include <tuple>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int PAD = 64;           // zero bytes kept past the row end
constexpr int N_BLOCKS = 16;
constexpr int MAX_CHUNKS = 4;     // DESC_MAX_CHUNKS in ops/dfa.py
constexpr unsigned FULL = 0xffffffffu;

// descriptor header slots (ops/dfa.py H_*)
enum {
  H_RUNS, H_SETS, H_EROS, H_UNITS, H_CHAINS, H_SPECS, H_PATTERNS,
  H_CLASS_WORDS, H_ERO_PASSES, H_OFF_RUNS, H_OFF_COLS, H_OFF_CLASS,
  H_OFF_EROS, H_OFF_CHAINS, H_OFF_TERMS, H_OFF_SPECS, H_OFF_WORDS
};
enum { TAIL_FF, TAIL_FP, TAIL_F0, TAIL_P0 };   // last-chunk masks
enum { MODE_COLUMN, MODE_BITS };
enum { TERM_LIT, TERM_RUN };

// ASCII-lowercase four bytes at once: bit 5 set on 'A'..'Z'
__device__ __forceinline__ uint32_t lower4(uint32_t v) {
  const uint32_t h = v & 0x7f7f7f7fu;
  const uint32_t ge_a = h + 0x3f3f3f3fu;       // bit 7: byte >= 'A'
  const uint32_t gt_z = h + 0x25252525u;       // bit 7: byte > 'Z'
  const uint32_t up = ~v & (ge_a ^ gt_z) & 0x80808080u;
  return v | (up >> 2);
}

// OR one thread's block bit into a pattern's mask, once per warp
__device__ __forceinline__ void record(bool hit, uint32_t bbit,
                                       uint32_t* slot) {
  if (__any_sync(FULL, hit)) {
    const uint32_t v = __reduce_or_sync(FULL, hit ? bbit : 0u);
    if ((threadIdx.x & 31) == 0) atomicOr(slot, v);
  }
}

// Zero exactly when the literal with chunks k[] starts at position i
// of this thread's window words q[] (q[t]: the lowered bytes at
// base+t .. base+t+3). Every chunk but the last is under full masks.
template <int C, int TAIL, int NQ>
__device__ __forceinline__ uint32_t diff(const uint32_t (&q)[NQ],
                                         const uint4 (&k)[C], int i) {
  constexpr int J = C - 1;
  const uint32_t lo = q[i + 8 * J], hi = q[i + 8 * J + 4];
  uint32_t z;
  if (TAIL == TAIL_FF) z = (lo ^ k[J].x) | (hi ^ k[J].y);
  else if (TAIL == TAIL_FP) z = (lo ^ k[J].x) | ((hi & k[J].w) ^ k[J].y);
  else if (TAIL == TAIL_F0) z = lo ^ k[J].x;
  else z = (lo & k[J].z) ^ k[J].x;
#pragma unroll
  for (int j = 0; j < J; ++j)
    z |= (q[i + 8 * j] ^ k[j].x) | (q[i + 8 * j + 4] ^ k[j].y);
  return z;
}

template <int POS>
using bits_t = typename std::conditional<POS == 16, uint16_t, uint8_t>::type;

// One literal: fold its POS positions into a block-mask vote (COLUMN)
// or a START bitmap of POS bits (BITS).
template <int C, int TAIL, int MODE, int POS, int NQ>
__device__ __forceinline__ void emit(const uint32_t (&q)[NQ],
                                     const uint4 (&k)[C], int target,
                                     bool valid, uint32_t bbit, int base,
                                     uint32_t* smask, bits_t<POS>* ubits,
                                     int unit_stride) {
  if (MODE == MODE_COLUMN) {
    bool any = false;
#pragma unroll
    for (int i = 0; i < POS; ++i) any |= diff<C, TAIL>(q, k, i) == 0u;
    record(any && valid, bbit, smask + target);
  } else {
    uint32_t bits = 0;
#pragma unroll
    for (int i = 0; i < POS; ++i)
      bits |= static_cast<uint32_t>(diff<C, TAIL>(q, k, i) == 0u) << i;
    if (valid)
      ubits[target * unit_stride + base / POS] = static_cast<bits_t<POS>>(bits);
  }
}

// One run of `count` literals of one shape; two at a time for C <= 2,
// so the next literal's loads overlap this one's compares.
template <int C, int TAIL, int MODE, int POS, int NQ>
__device__ __forceinline__ void lit_run(const uint32_t (&q)[NQ],
                                        const uint4* words,
                                        const int32_t* cols, int count,
                                        bool valid, uint32_t bbit, int base,
                                        uint32_t* smask, bits_t<POS>* ubits,
                                        int unit_stride) {
  int n = 0;
  if (C <= 2) {
    for (; n + 2 <= count; n += 2) {
      uint4 a[C], b[C];
#pragma unroll
      for (int j = 0; j < C; ++j) {
        a[j] = words[C * n + j];
        b[j] = words[C * (n + 1) + j];
      }
      emit<C, TAIL, MODE, POS>(q, a, cols[n], valid, bbit, base, smask,
                               ubits, unit_stride);
      emit<C, TAIL, MODE, POS>(q, b, cols[n + 1], valid, bbit, base, smask,
                               ubits, unit_stride);
    }
  }
  for (; n < count; ++n) {
    uint4 a[C];
#pragma unroll
    for (int j = 0; j < C; ++j) a[j] = words[C * n + j];
    emit<C, TAIL, MODE, POS>(q, a, cols[n], valid, bbit, base, smask,
                             ubits, unit_stride);
  }
}

// bitmap word w of `in` (nw words) moved to lower positions by k:
// out[p] = in[p + k], zero past the row end
__device__ __forceinline__ uint32_t shl_word(const uint32_t* in, int w,
                                             int k, int nw) {
  const int a = w + (k >> 5);
  const uint32_t lo = a < nw ? in[a] : 0u;
  const uint32_t hi = a + 1 < nw ? in[a + 1] : 0u;
  return __funnelshift_r(lo, hi, k & 31);
}

// bitmap word w of `in` moved to higher positions by d:
// out[p] = in[p - d], zero before the row start
__device__ __forceinline__ uint32_t shr_word(const uint32_t* in, int w,
                                             int d) {
  const int a = w - (d >> 5);
  const uint32_t hi = a >= 0 ? in[a] : 0u;
  const uint32_t lo = a >= 1 ? in[a - 1] : 0u;
  return __funnelshift_l(lo, hi, d & 31);
}

// the shift of log-doubling step k of an erosion by n (0: done)
__device__ __forceinline__ int ero_step(int n, int k) {
  int span = 1, step = 0;
  for (int j = 0; j <= k; ++j) {
    step = span < n ? min(span, n - span) : 0;
    span += step;
  }
  return step;
}

// the block bits (blocks of blk positions) of bitmap word w
__device__ __forceinline__ uint32_t word_blocks(uint32_t v, int w, int blk) {
  uint32_t r = 0;
  while (v) {
    const int b = (32 * w + __ffs(v) - 1) / blk;
    r |= 1u << b;
    const int end = (b + 1) * blk - 32 * w;   // first bit past block b
    v = end >= 32 ? 0u : v & (FULL << end);
  }
  return r;
}

#define LIT_CASE(C, T, M)                                                  \
  case ((C - 1) * 4 + T) * 2 + M:                                          \
    lit_run<C, T, M, POS>(q, words, cols, count, valid, bbit, base, smask, \
                          ubits, unit_stride);                             \
    break;
#define LIT_CASES(C)                                                      \
  LIT_CASE(C, 0, 0) LIT_CASE(C, 0, 1) LIT_CASE(C, 1, 0) LIT_CASE(C, 1, 1) \
  LIT_CASE(C, 2, 0) LIT_CASE(C, 2, 1) LIT_CASE(C, 3, 0) LIT_CASE(C, 3, 1)

template <int POS>
__global__ void __launch_bounds__(THREADS)
dfa_sieve_kernel(const uint8_t* __restrict__ seg, int B, int L,
                 const int32_t* __restrict__ gdesc, int desc_len,
                 uint16_t* __restrict__ out, uint8_t* __restrict__ hits) {
  constexpr int NQ = POS + 8 * MAX_CHUNKS - 4;   // window words per pass
  constexpr int NW = NQ / 4 + 1;                 // aligned words behind them
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const int n_runs = gdesc[H_RUNS], n_sets = gdesc[H_SETS];
  const int n_eros = gdesc[H_EROS];
  const int n_chains = gdesc[H_CHAINS], n_specs = gdesc[H_SPECS];
  const int n_patterns = gdesc[H_PATTERNS], W = gdesc[H_CLASS_WORDS];
  const int n_passes = gdesc[H_ERO_PASSES];
  const int nw = L / 32;                         // bitmap words per row
  const int row_words = (L + PAD) / 4;

  int32_t* desc = reinterpret_cast<int32_t*>(smem);
  uint32_t* smask = reinterpret_cast<uint32_t*>(desc + ((desc_len + 3) & ~3));
  uint32_t* raw = smask + ((n_patterns + 3) & ~3);
  uint32_t* low = raw + row_words;
  uint32_t* setbm = low + row_words;             // [n_sets][nw]
  uint32_t* ero0 = setbm + n_sets * nw;          // [n_eros][nw], ping
  uint32_t* ero1 = ero0 + n_eros * nw;           // pong
  uint32_t* ubm = ero1 + n_eros * nw;            // [n_units][nw]
  const uint8_t* rawb = reinterpret_cast<const uint8_t*>(raw);
  bits_t<POS>* ubits = reinterpret_cast<bits_t<POS>*>(ubm);
  const int unit_stride = L / POS;               // bits_t per unit bitmap

  for (int i = tid; i < desc_len; i += THREADS) desc[i] = gdesc[i];
  // the zero tails past L are written once and never overwritten
  for (int i = L / 4 + tid; i < row_words; i += THREADS) raw[i] = low[i] = 0u;
  __syncthreads();

  const int32_t* runs = desc + desc[H_OFF_RUNS];
  const uint32_t* cls = reinterpret_cast<const uint32_t*>(desc + desc[H_OFF_CLASS]);
  const int32_t* eros = desc + desc[H_OFF_EROS];
  const int32_t* chains = desc + desc[H_OFF_CHAINS];
  const int32_t* terms = desc + desc[H_OFF_TERMS];
  const int32_t* specs = desc + desc[H_OFF_SPECS];
  const uint32_t* ero_out = (n_passes - 1) & 1 ? ero1 : ero0;
  const int blk = L / N_BLOCKS;
  const int n_pass = (L / POS + THREADS - 1) / THREADS;

  for (int row = blockIdx.x; row < B; row += gridDim.x) {
    const uint4* src = reinterpret_cast<const uint4*>(seg + static_cast<size_t>(row) * L);
    for (int i = tid; i < L / 16; i += THREADS) {
      const uint4 v = src[i];
      reinterpret_cast<uint4*>(raw)[i] = v;
      reinterpret_cast<uint4*>(low)[i] =
          make_uint4(lower4(v.x), lower4(v.y), lower4(v.z), lower4(v.w));
    }
    for (int i = tid; i < n_patterns; i += THREADS) smask[i] = 0u;
    __syncthreads();

    // literals and the chains' lit units; every lane of a warp runs
    // every pass (record() votes warp-wide)
    for (int pass = 0; pass < n_pass; ++pass) {
      const int base = (pass * THREADS + tid) * POS;
      const bool valid = base < L;
      const uint32_t bbit = valid ? (1u << (base / blk)) : 0u;
      uint32_t w[NW];
#pragma unroll
      for (int i = 0; i < NW; i += 2) {
        const uint2 v = valid ? reinterpret_cast<const uint2*>(low)[(base >> 3) + i / 2]
                              : make_uint2(0u, 0u);
        w[i] = v.x;
        w[i + 1] = v.y;
      }
      uint32_t q[NQ];
#pragma unroll
      for (int i = 0; i < NQ; ++i)
        q[i] = __funnelshift_r(w[i >> 2], w[(i >> 2) + 1], 8 * (i & 3));

      for (int r = 0; r < n_runs; ++r) {
        const int32_t* rd = runs + 4 * r;
        const int count = rd[1];
        const uint4* words = reinterpret_cast<const uint4*>(desc + rd[2]);
        const int32_t* cols = desc + rd[3];
        switch (rd[0]) {
          LIT_CASES(1) LIT_CASES(2) LIT_CASES(3) LIT_CASES(4)
          default: break;
        }
      }
    }

    // set bitmaps: one class-table read per byte, one ballot per set
    for (int wd = warp; wd < nw; wd += WARPS) {
      const int b = rawb[32 * wd + lane];
      for (int cw = 0; cw < W; ++cw) {
        const uint32_t c = cls[b * W + cw];
        const int ns = min(32, n_sets - 32 * cw);
        for (int s = 0; s < ns; ++s) {
          const uint32_t v = __ballot_sync(FULL, (c >> s) & 1u);
          if (lane == 0) setbm[(32 * cw + s) * nw + wd] = v;
        }
      }
    }
    __syncthreads();

    // erosions, all in lockstep: pass k applies step k of each
    // (a copy once an erosion is done), ping-ponging ero0 / ero1
    for (int k = 0; k < n_passes; ++k) {
      uint32_t* dst = k & 1 ? ero1 : ero0;
      const uint32_t* from = k & 1 ? ero0 : ero1;
      for (int i = tid; i < n_eros * nw; i += THREADS) {
        const int e = i / nw, wd = i - e * nw;
        const uint32_t* in = k == 0 ? setbm + eros[2 * e] * nw : from + e * nw;
        const int step = ero_step(eros[2 * e + 1], k);
        uint32_t v = in[wd];
        if (step) v &= shl_word(in, wd, step, nw);
        dst[e * nw + wd] = v;
      }
      __syncthreads();
    }

    // chains (END block masks) and run specs (hits), a warp each
    for (int item = warp; item < n_chains + n_specs; item += WARPS) {
      if (item < n_chains) {
        const int32_t* cd = chains + 3 * item;
        const int n_terms = cd[1];
        const int32_t* td = terms + 3 * cd[2];
        uint32_t bits = 0;
        for (int wd = lane; wd < nw; wd += 32) {
          uint32_t v = FULL;
          for (int t = 0; t < n_terms; ++t) {
            const uint32_t* in = (td[3 * t] == TERM_LIT ? ubm : ero_out) + td[3 * t + 1] * nw;
            v &= shr_word(in, wd, td[3 * t + 2]);
          }
          bits |= word_blocks(v, wd, blk);
        }
        bits = __reduce_or_sync(FULL, bits);
        if (lane == 0) smask[cd[0]] = bits;
      } else {
        const int s = item - n_chains;
        const uint32_t* in = ero_out + specs[s] * nw;
        bool any = false;
        for (int wd = lane; wd < nw; wd += 32) any |= in[wd] != 0u;
        any = __any_sync(FULL, any);
        if (lane == 0) hits[static_cast<size_t>(row) * n_specs + s] = any;
      }
    }
    __syncthreads();
    // the same thread zeroes smask[i] for the next row: no sync needed
    for (int i = tid; i < n_patterns; i += THREADS)
      out[static_cast<size_t>(row) * n_patterns + i] = static_cast<uint16_t>(smask[i]);
  }
}

using kernel_t = void (*)(const uint8_t*, int, int, const int32_t*, int,
                          uint16_t*, uint8_t*);

// Resident CTAs the card holds at this shared-memory size, found once
// per (device, POS, smem): the attribute and occupancy queries stay
// off the launch path after the first call.
cudaError_t resident_ctas(int pos, kernel_t kernel, size_t smem, int* ctas) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, size_t>, int> cache;
  static std::map<std::pair<int, int>, size_t> smem_allowed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(dev, pos, smem);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *ctas = it->second;
    return cudaSuccess;
  }
  // the attribute is one value per function and device: only ever
  // raise it, so every size cached before stays launchable
  size_t& allowed = smem_allowed[std::make_pair(dev, pos)];
  if (smem > allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  *ctas = cache[key] = sms * (per_sm < 1 ? 1 : per_sm);
  return cudaSuccess;
}

}  // namespace

// segments [B, L] uint8 (L % 128 == 0, 16-byte aligned rows); desc
// int32[desc_len] with the counts the host read from its header;
// out [B, n_patterns] uint16; hits [B, n_specs] uint8 (unused when
// n_specs is 0). Each thread takes 16 positions where L % 256 == 0,
// else 8. Launches on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int dfa_blockmask_launch(const void* seg, int B, int L,
                                    const void* desc, int desc_len,
                                    int n_patterns, int n_sets, int n_eros,
                                    int n_units, void* out, void* hits,
                                    void* stream) {
  if (L % 128 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int pos = L % 256 == 0 ? 16 : 8;
  const size_t nw = L / 32;
  const size_t smem = 4 * (static_cast<size_t>((desc_len + 3) & ~3) +
                           ((n_patterns + 3) & ~3) + 2 * ((L + PAD) / 4) +
                           (static_cast<size_t>(n_sets) + 2 * n_eros + n_units) * nw);
  const kernel_t kernel = pos == 16 ? dfa_sieve_kernel<16> : dfa_sieve_kernel<8>;
  int ctas = 0;
  const cudaError_t err = resident_ctas(pos, kernel, smem, &ctas);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = B < ctas ? B : ctas;
  kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(seg), B, L, static_cast<const int32_t*>(desc),
      desc_len, static_cast<uint16_t*>(out), static_cast<uint8_t*>(hits));
  return static_cast<int>(cudaGetLastError());
}
