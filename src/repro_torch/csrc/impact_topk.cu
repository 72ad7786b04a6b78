// Fused impact scoring with a streaming top-k for Hopper (sm_90a): K4 and
// K5, one slice kernel over five kinds of input and one merge kernel.
//
// K4 replaces the Pallas TPU kernel src/repro/kernels/impact_score.py:
// _impact_kernel (entry fused_impact_topk). Per query row b it computes
//
//     score[d] = sum over query terms t, lanes l < len[t] with doc(t, l) == d
//                of w(t, l)
//
// and returns the k best docs (value descending, doc id ascending), never
// writing the (B, n_docs) score matrix to device memory. When k > n_docs
// the tail holds (NEG_INF, 0), as in the reference.
//
// K5 replaces _impact_q_kernel (entry fused_quantized_topk) in the same
// file: the lanes are u4+delta postings of a quantized index, decoded in
// the kernel. For term t (only where qv[t] > 0) and lane l < len[t]:
//
//     code = (par[t] + l) odd ? byte(t, l) >> 4 : byte(t, l) & 0xF
//     doc  = gap(t, 0) + ... + gap(t, l)
//     w    = (lo[t] + (code - 1) * step[t]) * qv[t]   (code > 0)
//
// Code 0 is an escape phantom: it weighs exactly 0, but its gap still
// advances the running sum. The nibble parity comes from the absolute
// posting position (par = the term's first posting), not from the lane.
// The products and the sum are rounded separately (__fmul_rn, __fadd_rn),
// never contracted into an FMA, so a weight is bit for bit the plain
// PyTorch version's. K4's weight is __fmul_rn(val, qv), the single
// rounding of the plain version's `where(valid, val, 0) * qv`.
//
// Five sources feed the one slice kernel (`Src` below), each a list of
// query terms with a posting range and one or two element streams:
//   K4Index  the query rep and an InvertedIndex read in place: term
//            (b, t) is vocab id q_idx[b, t], its postings
//            postings_doc / postings_val[term_starts[id] + l];
//   K4Window the gathered (B, W) windows: term (b, t) starts at
//            b * W + t * seg_len, and qv = 1 (an exact product);
//   K5Index  the query rep and a QuantizedIndex read in place: deltas (u8
//            or u16), packed_vals (two codes a byte), term_lens (u16 or
//            i32), term_lo / term_hi (f16; step = (hi - lo) * STEP_SCALE,
//            the f32 reciprocal of 14, as the plain version computes it);
//   K5Window the gathered (B, Q, L) i32 byte and gap windows: term (b, t)
//            starts at (b * Q + t) * L, its parity base is starts[b, t].
//   K4Ceil   the tier-1 ceilings of the two-tier pruned scorer
//            (src/repro/retrieval/engine/pruning.py upper_bound_scores,
//            then lax.top_k): as K4Index, but it stages postings_doc only
//            and every lane of term t weighs c[t] = __fmul_rn(q_val,
//            term_ubs[id]), the term's ceiling; postings_val is never read.
// A window batch is thus an index whose term (b, t) starts at a computed
// offset: the window entries run the same kernel as the in-place ones.
//
// Design. The grid is (query row, doc slice): B * S blocks, S chosen from
// B, n_docs and the SM count so that B * S fills the card once (B 8: 16
// slices of 1024-1216 docs on 132 SMs; B 64: 2 or 3), each slice at most
// NS_MAX docs whose scores live in shared memory. A block walks its
// query's terms in chunks of QC and each chunk's postings in rounds of up
// to RL lanes:
//   1. stage: every warp issues cp.async copies of its terms' postings
//      (16-byte pieces of both streams, each range rounded out to 16
//      bytes, the array's end zero-filled) before any is used, so the
//      round pays one device-memory latency, not one per term;
//   2. decode: one warp a term, 128 lanes a step (4 a lane), from shared
//      memory. K5 prefix-sums the gaps: each lane its 4, a warp scan of
//      the lanes' sums, the carry of the earlier steps (and rounds).
//      Lanes whose doc lies in the slice and whose weight is not 0 are
//      kept (K4 reads every lane of the query too: the postings of a term
//      ascend by doc, but the window's padding does not, and one load
//      wave beats a binary search's chain);
//   3. route: each kept lane goes to the warp that owns its doc (doc % 16)
//      in term order: counts per (owner, term), one block scan, placement;
//   4. fold: each warp adds its docs' lanes into the scores, 32 at a time;
//      lanes of one doc in a group of 32 (__match_any_sync) are summed by
//      the lowest lane in lane order. A doc occurs at most once per term,
//      so every doc's sum is taken in term order, 0 + w(t0) + w(t1) + ...:
//      bit for bit the plain version's, whatever S is.
// The slice's own top-k (min(k, its docs), value descending then id
// ascending, as one 64-bit key each) needs no rounds: for k <= 32 a warp
// bitonic sort of the threads' own best keys gives the k-th best of
// those, T (ceil(docs / 256) warps select, at most 8 docs a thread, at a
// named barrier of their own); only docs at or above T can be in the top
// k, and each of those few is placed by counting the keys above it. For
// 32 < k <= 512 (the pruned path's budgets C + 1) T is the k-th best of
// the block's 512 thread bests, each placed by counting the other 511; a
// larger k places every doc by counting (O(docs^2) a slice). The
// merge kernel places every entry of a row's S sorted lists by counting
// the entries above it. With S = 1 the slice kernel writes (B, k)
// itself. The lists live in a device workspace the wrapper allocates
// (impact_topk_workspace); the merge is a programmatic dependent launch,
// so its launch overlaps the slices.
//
// Bound on the H100: the bytes. An in-place call reads the query rep
// (8 bytes a term), two or four columns of each live term, the postings
// of the distinct query terms once (K4 8 bytes a posting; K5 1.5 or 2.5
// bytes) and writes (B, k) results: at the serving shapes 0.08-1.4 MB,
// under half a microsecond at 3.35 TB/s, against 13-17 us measured at B 8
// (PERF.md). The ceiling entry reads 4 bytes a posting (the doc id) and
// three columns a term. So the time is a chain of dependent steps: the
// launches, the term columns' loads, the staged postings' one wave, then
// the decode (every slice decodes its whole query: K5's gap sums need
// every lane), the routing, the fold and the top-k, each behind a
// barrier.

#include <algorithm>
#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;          // slice kernel
constexpr int WARPS = THREADS / 32;   // doc owners: doc & (WARPS - 1)
constexpr int MERGE_THREADS = 256;    // merge kernel for k <= SMALL_K,
constexpr int MERGE_WIDE_THREADS = 1024;  // and past it
constexpr int QC = 64;                // query terms a chunk
constexpr int RL = 4096;              // posting lanes staged a round
constexpr int CW = 2 * RL + 16 * QC;  // staging words: 2 streams + slack
constexpr int NS_MIN = 128;           // docs a slice, at least ...
constexpr int NS_MAX = 8192;          // ... and at most (scores in smem)
constexpr int MERGE_STAGE_KEYS = 8192;  // merge entries staged in smem,
constexpr int MERGE_LINEAR_KEYS = 4096;  // counted linearly up to here
constexpr int SMALL_K = 32;           // slice top-k by warp threshold ...
constexpr int MID_K = THREADS;        // ... by block threshold up to here
constexpr int MID_CAP = (CW - 2 * THREADS) / 2;  // its candidates' room
constexpr float NEG_INF = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

static_assert(WARPS * QC == 2 * THREADS, "the route scan takes 2 a thread");
static_assert(WARPS * SMALL_K * 2 + SMALL_K * (NS_MAX / THREADS) * 2 <= CW,
              "the threshold top-k's pool and candidates fit the staging");
static_assert(2 * (THREADS + MID_CAP) <= CW,
              "the block threshold's pool and candidates fit the staging");

// ------------------------------------------------------------------ keys

// An unsigned key that orders floats as floats (NaN aside); 0 is below
// every float but the all-ones NaN, and marks "nothing".
__device__ __forceinline__ unsigned fkey(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// Warp-wide inclusive prefix sum.
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// A (value, id) pair as one key: larger is better (value descending,
// then id ascending); 0 is below every pair.
__device__ __forceinline__ unsigned long long make_key(float v, int id) {
  return ((unsigned long long)fkey(v) << 32) | (unsigned)~id;
}

__device__ __forceinline__ void put_key(unsigned long long x, float* v,
                                        int* id) {
  *v = key_value((unsigned)(x >> 32));
  *id = (int)~(unsigned)x;
}

// Sort the warp's 32 keys descending (bitonic, one a lane): lane r ends
// with the r-th largest.
__device__ __forceinline__ unsigned long long warp_sort_desc(
    unsigned long long x) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1)
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
      const unsigned long long y = __shfl_xor_sync(FULL, x, j);
      const bool keep_max = ((lane & j) == 0) == ((lane & size) == 0);
      x = keep_max ? (x > y ? x : y) : (x < y ? x : y);
    }
  return x;
}

// ------------------------------------------------------------- cp.async

// Copy 16 bytes (the first src_bytes of them; the rest zero-filled).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- terms

// One query term of a chunk: its postings (pos .. pos + len - 1 in the
// stream arrays), its weights, and this round's share of its lanes.
struct Term {
  long long pos;   // first element of the term in the streams
  long long w1;    // first staged 16-byte quad of stream 1 (from its base)
  long long w2;    // ... of stream 2
  int len;         // lanes (0: skipped)
  int off;         // flat lane offset in the chunk
  int par;         // K5: parity base of the nibbles
  float qv, lo, step;
  int a, b;        // this round's lanes a .. b - 1
  int tl;          // their first slot in the entry buffer
  int sb1, sb2;    // shared byte of lane a in stream 1 / stream 2
  int ws1, ws2;    // first staging quad of stream 1 / 2
  int n1, n2;      // staged quads of stream 1 / 2
  int kept;        // kept lanes this round
  int carry;       // K5: the term's gap sum before lane a
};

// A stream of fixed-size elements, or (es == 0) of nibbles two a byte.
// `base` is 16-byte aligned (the array's pointer rounded down, within the
// same 16 bytes); element e lies at byte off0 + e * es (nibbles: off0 +
// e / 2); nbytes = off0 + the array's bytes, past which nothing is read.
struct Stream {
  const unsigned char* base;
  long long off0, nbytes;
};

__host__ __device__ inline Stream make_stream(const void* p, long long n) {
  const uintptr_t u = reinterpret_cast<uintptr_t>(p);
  Stream s;
  s.base = reinterpret_cast<const unsigned char*>(u & ~uintptr_t(15));
  s.off0 = (long long)(u & 15);
  s.nbytes = s.off0 + n;
  return s;
}

// ------------------------------------------------------------- sources

// The vocab row a query id reads, by the reference's rule for a gather
// (JAX's, src/repro/retrieval/score.py `index.term_starts[qi]`): a
// negative id plus V, then clamped to [0, V - 1]. The plain versions
// apply the same rule (kernels/impact_score.py `term_rows`).
__device__ __forceinline__ int vocab_row(int id, int V) {
  if (id < 0) id += V;
  return min(max(id, 0), V - 1);
}

struct K4Index {
  static constexpr bool kQuant = false, kCeil = false;
  static constexpr int ES1 = 4, ES2 = 4;  // doc i32, val f32
  const int* q_idx;
  const float* q_val;
  const int* starts;
  const int* lens;
  Stream s1, s2;
  int Q, V;
  __device__ void meta(int b, int t, Term& m) const {
    const size_t j = (size_t)b * Q + t;
    const int id = vocab_row(q_idx[j], V);
    m.qv = q_val[j];
    if (m.qv > 0.0f && V > 0) {
      m.pos = starts[id];
      m.len = max(lens[id], 0);
    }
  }
};

struct K4Window {
  static constexpr bool kQuant = false, kCeil = false;
  static constexpr int ES1 = 4, ES2 = 4;  // doc i32, w f32
  Stream s1, s2;
  long long W;
  int seg, Q;
  __device__ void meta(int b, int t, Term& m) const {
    m.qv = 1.0f;
    m.pos = (long long)b * W + (long long)t * seg;
    m.len = (int)min((long long)seg, W - (long long)t * seg);
  }
};

template <typename LensT, typename DeltaT>
struct K5Index {
  static constexpr bool kQuant = true, kCeil = false;
  static constexpr int ES1 = (int)sizeof(DeltaT), ES2 = 0;  // gaps, nibbles
  const int* q_idx;
  const float* q_val;
  const int* starts;
  const LensT* lens;
  const __half* lo;
  const __half* hi;
  Stream s1, s2;
  float step_scale;
  int Q, V;
  __device__ void meta(int b, int t, Term& m) const {
    const size_t j = (size_t)b * Q + t;
    const int id = vocab_row(q_idx[j], V);
    m.qv = q_val[j];
    if (m.qv > 0.0f && V > 0) {
      m.pos = starts[id];
      m.len = max((int)lens[id], 0);
      m.par = (int)(m.pos & 1);
      m.lo = __half2float(lo[id]);
      m.step = __fmul_rn(__fsub_rn(__half2float(hi[id]), m.lo), step_scale);
    }
  }
};

struct K5Window {
  static constexpr bool kQuant = true, kCeil = false;
  static constexpr int ES1 = 4, ES2 = 4;  // gap i32, packed byte i32
  const int* starts;
  const int* lens;
  const float* qv;
  const float* lo;
  const float* step;
  Stream s1, s2;
  int Q, L;
  __device__ void meta(int b, int t, Term& m) const {
    const size_t j = (size_t)b * Q + t;
    m.qv = qv[j];
    if (m.qv > 0.0f) {
      m.len = min(max(lens[j], 0), L);
      m.pos = (long long)j * L;
      m.par = starts[j];
      m.lo = lo[j];
      m.step = step[j];
    }
  }
};

// K4's tier-1 ceilings: one stream (the doc ids); the term's weight is its
// ceiling c = q_val * term_ubs[id], one rounding, every lane.
struct K4Ceil {
  static constexpr bool kQuant = false, kCeil = true;
  static constexpr int ES1 = 4, ES2 = 4;  // doc i32 (no stream 2)
  const int* q_idx;
  const float* q_val;
  const int* starts;
  const int* lens;
  const float* ubs;
  Stream s1, s2;
  int Q, V;
  __device__ void meta(int b, int t, Term& m) const {
    const size_t j = (size_t)b * Q + t;
    const int id = vocab_row(q_idx[j], V);
    m.qv = q_val[j];
    if (m.qv > 0.0f && V > 0) {
      m.pos = starts[id];
      m.len = max(lens[id], 0);
      m.qv = __fmul_rn(m.qv, ubs[id]);
    }
  }
};

// First and one-past-last byte of lanes a .. b - 1 of a stream.
template <int ES>
__device__ __forceinline__ void lane_bytes(const Stream& s, long long pos,
                                           int a, int b, long long* b0,
                                           long long* b1) {
  if (ES > 0) {
    *b0 = s.off0 + (pos + a) * ES;
    *b1 = s.off0 + (pos + b) * ES;
  } else {
    *b0 = s.off0 + ((pos + a) >> 1);
    *b1 = s.off0 + ((pos + b - 1) >> 1) + 1;
  }
}

// ------------------------------------------------------------ the slice

struct Smem {
  float* scores;     // (NS,) this slice's scores
  unsigned* stage;   // (CW,) staged words; then the routed lanes
  int* edoc;         // (RL,) kept lanes, in each term's slots
  float* ew;
  int* cnt;          // (WARPS, QC) kept lanes a (owner, term)
};

inline size_t slice_fixed_bytes() {
  return (size_t)(CW + 2 * RL + WARPS * QC) * 4;
}

__host__ __device__ inline size_t pad4(size_t n) {
  return (n + 3) & ~size_t(3);
}

// Round [r0, r1) of the chunk's flat lanes: each term's share a .. b - 1,
// its staged 16-byte quads and their shared-memory offsets, its entry
// slots. Warp 0 only (QC = 64 terms, two a lane); a barrier must follow.
template <class Src>
__device__ void plan_round(const Src& src, Term* tm, int r0, int r1) {
  const int lane = threadIdx.x % 32;
  int nl[2], nq[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    Term& m = tm[2 * lane + j];
    m.a = min(max(r0 - m.off, 0), m.len);
    m.b = min(max(r1 - m.off, 0), m.len);
    m.n1 = m.n2 = 0;
    m.sb1 = m.sb2 = 0;
    m.kept = 0;
    if (m.b > m.a) {
      long long b0, b1;
      lane_bytes<Src::ES1>(src.s1, m.pos, m.a, m.b, &b0, &b1);
      m.w1 = b0 >> 4;
      m.n1 = (int)(((b1 + 15) >> 4) - m.w1);
      m.sb1 = (int)(b0 - 16 * m.w1);
      if (!Src::kCeil) {
        lane_bytes<Src::ES2>(src.s2, m.pos, m.a, m.b, &b0, &b1);
        m.w2 = b0 >> 4;
        m.n2 = (int)(((b1 + 15) >> 4) - m.w2);
        // nibbles: lane l's byte is sb2 + ((pos & 1) + l) / 2
        m.sb2 = (int)(b0 - 16 * m.w2) -
                (Src::ES2 > 0 ? 0 : ((int)(m.pos & 1) + m.a) >> 1);
      }
    }
    nl[j] = m.b - m.a;
    nq[j] = m.n1 + m.n2;
  }
  const int lanes = nl[0] + nl[1], quads = nq[0] + nq[1];
  const int lane_ex = warp_scan(lanes, lane) - lanes;
  const int quad_ex = warp_scan(quads, lane) - quads;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    Term& m = tm[2 * lane + j];
    m.tl = lane_ex + (j ? nl[0] : 0);
    m.ws1 = quad_ex + (j ? nq[0] : 0);
    m.ws2 = m.ws1 + m.n1;
    m.sb1 += 16 * m.ws1;
    m.sb2 += 16 * m.ws2;
  }
}

// Copy this round's quads of every term into shared memory (cp.async; the
// caller waits). Warp w takes terms w, w + WARPS, ...
template <class Src>
__device__ void stage_round(const Src& src, const Term* tm,
                            unsigned* stage) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  for (int t = warp; t < QC; t += WARPS) {
    const Term& m = tm[t];
    if (m.b <= m.a) continue;
    for (int i = lane; i < m.n1; i += 32) {
      const long long g = 16 * (m.w1 + i);
      cp_async16(stage + 4 * (m.ws1 + i), src.s1.base + g,
                 (int)min(16LL, src.s1.nbytes - g));
    }
    for (int i = lane; i < m.n2; i += 32) {
      const long long g = 16 * (m.w2 + i);
      cp_async16(stage + 4 * (m.ws2 + i), src.s2.base + g,
                 (int)min(16LL, src.s2.nbytes - g));
    }
  }
}

// Keep lane (doc - d0, w) in term t's entry slots, in lane order, and
// count it for its owner warp. Returns the term's kept lanes so far.
__device__ __forceinline__ int keep_lane(const Smem& sm, bool keep,
                                         unsigned dl, float w, int t, int at,
                                         int kept) {
  const int lane = threadIdx.x % 32;
  const unsigned bal = __ballot_sync(FULL, keep);
  if (keep) {
    const int p = at + kept + __popc(bal & ((1u << lane) - 1u));
    sm.edoc[p] = (int)dl;
    sm.ew[p] = w;
    atomicAdd(sm.cnt + (dl & (WARPS - 1)) * QC + t, 1);
  }
  return kept + __popc(bal);
}

// Decode this round's staged lanes: one warp a term, each lane taking DV
// lanes a step (K4: 32 apart; K5: consecutive, a serial prefix of its DV
// gaps, then one warp scan of the lanes' totals and the carry of the
// earlier steps).
constexpr int DV = 4;

// Lanes c0 .. c0 + 32 * DV - 1 of term t (those below m.b): keep the ones
// in the slice with a weight, advancing the term's kept count and carry.
template <class Src>
__device__ __forceinline__ void decode_step(const Term& m, int t, int c0,
                                            const unsigned char* sb,
                                            const Smem& sm, int d0, int ns,
                                            int* kept, int* carry) {
  const int lane = threadIdx.x % 32;
  bool keep[DV];
  float w[DV];
  unsigned dl[DV];
  if (!Src::kQuant) {  // lanes c0 + lane + 32 v: no bank conflicts
#pragma unroll
    for (int v = 0; v < DV; ++v) {
      const int l = c0 + lane + 32 * v, i = l - m.a;
      keep[v] = false;
      w[v] = 0.0f;
      dl[v] = 0;
      if (l < m.b) {
        const int doc = *reinterpret_cast<const int*>(sb + m.sb1 + 4 * i);
        w[v] = Src::kCeil ? m.qv
                          : __fmul_rn(*reinterpret_cast<const float*>(
                                          sb + m.sb2 + 4 * i),
                                      m.qv);
        dl[v] = (unsigned)doc - (unsigned)d0;
        keep[v] = w[v] != 0.0f && dl[v] < (unsigned)ns;
      }
    }
  } else {
    const int l0 = c0 + DV * lane;
    int gap[DV], code[DV];
#pragma unroll
    for (int v = 0; v < DV; ++v) {
      const int l = l0 + v, i = l - m.a;
      gap[v] = code[v] = 0;
      if (l < m.b) {
        if (Src::ES1 == 1)
          gap[v] = sb[m.sb1 + i];
        else if (Src::ES1 == 2)
          gap[v] = *reinterpret_cast<const uint16_t*>(sb + m.sb1 + 2 * i);
        else
          gap[v] = *reinterpret_cast<const int*>(sb + m.sb1 + 4 * i);
        const int byte =
            Src::ES2 == 0
                ? (int)sb[m.sb2 + (((int)(m.pos & 1) + l) >> 1)]
                : *reinterpret_cast<const int*>(sb + m.sb2 + 4 * i);
        code[v] = ((m.par + l) & 1) ? (byte >> 4) : (byte & 0xF);
      }
    }
#pragma unroll
    for (int v = 1; v < DV; ++v) gap[v] += gap[v - 1];
    const int incl = warp_scan(gap[DV - 1], lane);
    const int base = *carry + incl - gap[DV - 1];
    *carry += __shfl_sync(FULL, incl, 31);
#pragma unroll
    for (int v = 0; v < DV; ++v) {
      keep[v] = false;
      w[v] = 0.0f;
      dl[v] = 0;
      if (code[v] > 0) {  // 0 past the term's lanes too
        w[v] = __fmul_rn(
            __fadd_rn(m.lo, __fmul_rn((float)(code[v] - 1), m.step)), m.qv);
        dl[v] = (unsigned)(base + gap[v]) - (unsigned)d0;
        keep[v] = w[v] != 0.0f && dl[v] < (unsigned)ns;
      }
    }
  }
#pragma unroll
  for (int v = 0; v < DV; ++v)
    *kept = keep_lane(sm, keep[v], dl[v], w[v], t, m.tl, *kept);
}

template <class Src>
__device__ void decode_round(Term* tm, const Smem& sm, int d0, int ns) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const unsigned char* sb = reinterpret_cast<const unsigned char*>(sm.stage);
  for (int t = warp; t < QC; t += WARPS) {
    const Term m = tm[t];
    if (m.b <= m.a) continue;
    int kept = 0, carry = m.carry;
    for (int c0 = m.a; c0 < m.b; c0 += 32 * DV)
      decode_step<Src>(m, t, c0, sb, sm, d0, ns, &kept, &carry);
    if (lane == 0) {
      tm[t].kept = kept;
      tm[t].carry = carry;
    }
  }
}

// Turn the (owner, term) counts into offsets, owner-major (an exclusive
// block scan, two counts a thread); ostart[o] is owner o's first lane.
__device__ void route_offsets(int* cnt, int* ostart, int* wsum) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int i0 = 2 * tid;
  const int c0 = cnt[i0], c1 = cnt[i0 + 1], x = c0 + c1;
  const int inc = warp_scan(x, lane);
  if (lane == 31) wsum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int y = warp_scan(lane < WARPS ? wsum[lane] : 0, lane);
    if (lane < WARPS) wsum[WARPS + lane] = y;
  }
  __syncthreads();
  const int base = (warp > 0 ? wsum[WARPS + warp - 1] : 0) + inc - x;
  cnt[i0] = base;
  cnt[i0 + 1] = base + c0;
  if (i0 % QC == 0) ostart[i0 / QC] = base;
  if (tid == THREADS - 1) ostart[WARPS] = base + x;
}

// Move each kept lane to its owner's list, terms in order.
__device__ void route_round(const Term* tm, const Smem& sm) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  int* rdoc = reinterpret_cast<int*>(sm.stage);
  float* rw = reinterpret_cast<float*>(sm.stage + RL);
  for (int t = warp; t < QC; t += WARPS) {
    const int kept = tm[t].kept, at = tm[t].tl;
    for (int i = lane; i < kept; i += 32) {
      const int dl = sm.edoc[at + i];
      const int p = atomicAdd(sm.cnt + (dl & (WARPS - 1)) * QC + t, 1);
      rdoc[p] = dl;
      rw[p] = sm.ew[at + i];
    }
  }
}

// Warp w adds its lanes into the scores of the docs it owns, in list
// (= term) order: the lowest lane of a doc's group sums the group.
__device__ void fold_round(const Smem& sm, const int* ostart) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int* rdoc = reinterpret_cast<const int*>(sm.stage);
  const float* rw = reinterpret_cast<const float*>(sm.stage + RL);
  const int e1 = ostart[warp + 1];
  for (int c = ostart[warp]; c < e1; c += 32) {
    const int i = c + lane;
    const bool act = i < e1;
    const int d = act ? rdoc[i] : -1 - lane;
    const unsigned peers = __match_any_sync(FULL, d);
    if (act && lane == __ffs(peers) - 1) {
      float s = sm.scores[d];
      for (unsigned m = peers; m; m &= m - 1u)
        s = __fadd_rn(s, rw[c + __ffs(m) - 1]);
      sm.scores[d] = s;
    }
    __syncwarp();
  }
}

// The slice's top ks (<= its ns docs, d0 the first) into out_v / out_i,
// value descending then id ascending. ks <= SMALL_K: the first
// ceil(ns / SEL_DOCS) warps select (at most 8 docs a thread while that is
// under 16 warps), the others leave. Every doc in the top ks has a key at
// least the ks-th largest of the selecting threads' own best keys (T): T
// comes from each warp's sorted bests (with one warp directly; else from
// a pool of their top ks, each placed by counting), and the top ks from
// the few docs at or above T, each placed by counting the keys above its
// own. The selecting warps meet at named barrier 1. SMALL_K < ks <= MID_K
// (the pruned path's candidate budgets C + 1): the same with the block's
// THREADS bests as the pool, T the one best that ks - 1 others beat, the
// docs at or above T (at most ks times the docs a thread) placed by
// counting among themselves, unless more than MID_CAP are. Else every doc
// is placed by counting all of them. `work` holds the pool and the
// candidates (the staging words).
constexpr int SEL_DOCS = 256;

__device__ __forceinline__ void sel_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

template <bool kBig>
__device__ void slice_topk(const float* scores, int ns, int d0, int ks,
                           float* out_v, int* out_i, unsigned* work,
                           unsigned long long* s_t, int* s_nc) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (kBig && ks > SMALL_K && ks <= MID_K) {
    unsigned long long* pool = reinterpret_cast<unsigned long long*>(work);
    unsigned long long* cand = pool + THREADS;
    unsigned long long best = 0ull;
    for (int i = tid; i < ns; i += THREADS) {
      const unsigned long long x = make_key(scores[i], d0 + i);
      best = x > best ? x : best;
    }
    pool[tid] = best;
    if (tid == 0) *s_nc = 0;
    __syncthreads();
    // ks <= min(ns, THREADS) threads hold a doc: one real key is beaten
    // by exactly ks - 1 others
    if (best != 0ull) {
      int r = 0;
#pragma unroll 8
      for (int q = 0; q < THREADS; ++q) r += pool[q] > best;
      if (r == ks - 1) *s_t = best;
    }
    __syncthreads();
    const unsigned long long t = *s_t;
    for (int i = tid; i < ns; i += THREADS) {
      const unsigned long long x = make_key(scores[i], d0 + i);
      if (x >= t) {
        const int c = atomicAdd(s_nc, 1);
        if (c < MID_CAP) cand[c] = x;
      }
    }
    __syncthreads();
    const int nc = *s_nc;
    if (nc <= MID_CAP) {
      for (int c = tid; c < nc; c += THREADS) {
        const unsigned long long x = cand[c];
        int r = 0;
#pragma unroll 8
        for (int q = 0; q < nc; ++q) r += cand[q] > x;
        if (r < ks) put_key(x, out_v + r, out_i + r);
      }
      return;
    }
  }
  if (kBig && ks > SMALL_K) {
    for (int i = tid; i < ns; i += THREADS) {
      const unsigned long long x = make_key(scores[i], d0 + i);
      int r = 0;
#pragma unroll 8
      for (int q = 0; q < ns; ++q) r += make_key(scores[q], d0 + q) > x;
      if (r < ks) put_key(x, out_v + r, out_i + r);
    }
    return;
  }
  const int sel = min(WARPS, (ns + SEL_DOCS - 1) / SEL_DOCS);
  if (warp >= sel) return;
  const int nthr = 32 * sel;
  unsigned long long* pool = reinterpret_cast<unsigned long long*>(work);
  unsigned long long* cand = pool + WARPS * SMALL_K;
  unsigned long long best = 0ull;
  for (int i = tid; i < ns; i += nthr) {
    const unsigned long long x = make_key(scores[i], d0 + i);
    best = x > best ? x : best;
  }
  best = warp_sort_desc(best);
  if (tid == 0) *s_nc = 0;
  unsigned long long t;
  if (sel == 1) {
    t = __shfl_sync(FULL, best, ks - 1);  // >= ks lanes hold a doc
    __syncwarp();
  } else {
    if (lane < ks) pool[warp * ks + lane] = best;
    sel_sync(nthr);
    const int np = sel * ks;
    if (tid < np) {
      const unsigned long long x = pool[tid];
      int r = 0;
#pragma unroll 8
      for (int q = 0; q < np; ++q) r += pool[q] > x;
      if (r == ks - 1) *s_t = x;  // one real key: >= ks real keys in pool
    }
    sel_sync(nthr);
    t = *s_t;
  }
  for (int i = tid; i < ns; i += nthr) {
    const unsigned long long x = make_key(scores[i], d0 + i);
    if (x >= t) cand[atomicAdd(s_nc, 1)] = x;
  }
  if (sel == 1)
    __syncwarp();
  else
    sel_sync(nthr);
  const int nc = *s_nc;
  for (int c = tid; c < nc; c += nthr) {
    const unsigned long long x = cand[c];
    int r = 0;
#pragma unroll 8
    for (int q = 0; q < nc; ++q) r += cand[q] > x;
    if (r < ks) put_key(x, out_v + r, out_i + r);
  }
}

// One block per (query row, doc slice): score the slice's docs from every
// query term's postings, then write its top min(k, slice) (S > 1: to the
// row's list KS-strided in the workspace; S == 1: the row's k results,
// tail included). kBig: k > SMALL_K (the paths past the warp threshold
// are compiled in only then).
template <class Src, bool kBig>
__global__ void __launch_bounds__(THREADS)
    slice_kernel(const Src src, int n_docs, int k, int S, int NS, int KS,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Term tm[QC];
  __shared__ int ostart[WARPS + 1];
  __shared__ int wsum[2 * WARPS];
  __shared__ unsigned long long s_t;
  __shared__ int s_total, s_nc;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int b = blockIdx.x / S, s = blockIdx.x % S;
  const int d0 = s * NS, ns = min(NS, n_docs - d0);
  Smem sm;
  sm.scores = reinterpret_cast<float*>(smem);
  sm.stage = reinterpret_cast<unsigned*>(sm.scores + pad4(NS));
  sm.edoc = reinterpret_cast<int*>(sm.stage + CW);
  sm.ew = reinterpret_cast<float*>(sm.edoc + RL);
  sm.cnt = reinterpret_cast<int*>(sm.ew + RL);

  // let the merge kernel's blocks launch once every slice block runs
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  for (int i = tid; i < ns; i += THREADS) sm.scores[i] = 0.0f;
  for (int t0 = 0; t0 < src.Q; t0 += QC) {
    if (tid < QC) {
      Term m;
      m.pos = 0;
      m.len = 0;
      m.par = 0;
      m.qv = m.lo = m.step = 0.0f;
      m.carry = 0;
      if (t0 + tid < src.Q) src.meta(b, t0 + tid, m);
      tm[tid] = m;
    }
    __syncthreads();
    if (warp == 0) {
      const int l0 = tm[2 * lane].len, l1 = tm[2 * lane + 1].len;
      const int inc = warp_scan(l0 + l1, lane);
      tm[2 * lane].off = inc - l0 - l1;
      tm[2 * lane + 1].off = inc - l1;
      if (lane == 31) s_total = inc;
    }
    __syncthreads();
    const int total = s_total;
    for (int r0 = 0; r0 < total; r0 += RL) {
      if (warp == 0) plan_round(src, tm, r0, min(total, r0 + RL));
      for (int i = tid; i < WARPS * QC; i += THREADS) sm.cnt[i] = 0;
      __syncthreads();
      stage_round(src, tm, sm.stage);
      cp_async_wait_all();
      __syncthreads();
      decode_round<Src>(tm, sm, d0, ns);
      __syncthreads();
      route_offsets(sm.cnt, ostart, wsum);
      __syncthreads();
      route_round(tm, sm);
      __syncthreads();
      fold_round(sm, ostart);
      __syncthreads();
    }
  }

  const int ks = min(k, ns);
  const size_t o = S == 1 ? (size_t)b * k : ((size_t)b * S + s) * KS;
  slice_topk<kBig>(sm.scores, ns, d0, ks, out_v + o, out_i + o, sm.stage,
                   &s_t,
             &s_nc);
  if (S == 1)
    for (int i = ks + tid; i < k; i += THREADS) {
      out_v[o + i] = NEG_INF;
      out_i[o + i] = 0;
    }
}

// One block per query row: merge the row's S slice lists (sorted, slice s
// holding min(k, its docs) entries at stride KS) into its k results. Each
// entry's place is the count of the row's entries above it (the keys are
// distinct). `staged` (at most MERGE_STAGE_KEYS entries, as on the main
// path): the lists as keys in shared memory (0 past each list's end),
// counted linearly for k <= SMALL_K and up to MERGE_LINEAR_KEYS a row (at
// B 8, S 16 x KS 10, 2.5 us faster than searching them, PERF.md), else
// binary-searched (the pruned path's KS 65-257: S log KS steps an entry,
// not S KS, by MERGE_WIDE_THREADS threads to hide their latency); else
// each list binary-searched in device memory. The tail past n_docs is
// (NEG_INF, 0). Launched as a programmatic dependent of the slice kernel:
// it waits for its lists. NT: MERGE_THREADS for k <= SMALL_K, else
// MERGE_WIDE_THREADS.
template <int NT>
__global__ void __launch_bounds__(NT)
    merge_kernel(const float* __restrict__ lv, const int* __restrict__ li,
                 float* __restrict__ vals, int* __restrict__ idx, int S,
                 int NS, int KS, int n_docs, int k, int staged) {
  extern __shared__ __align__(16) unsigned char smem[];
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int tid = threadIdx.x, b = blockIdx.x;
  const int n = S * KS;
  const float* gv = lv + (size_t)b * n;
  const int* gi = li + (size_t)b * n;
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);
  auto len = [&](int s) { return min(KS, n_docs - s * NS); };
  if (staged) {
    for (int j = tid; j < n; j += NT)
      keys[j] = j % KS < len(j / KS) ? make_key(gv[j], gi[j]) : 0ull;
    __syncthreads();
  }
  const int total = min(k, n_docs);
  float* out_v = vals + (size_t)b * k;
  int* out_i = idx + (size_t)b * k;
  for (int j = tid; j < n; j += NT) {
    if (j % KS >= len(j / KS)) continue;
    const unsigned long long x =
        staged ? keys[j] : make_key(gv[j], gi[j]);
    int r = 0;
    if (staged && NT == MERGE_THREADS && n <= MERGE_LINEAR_KEYS) {
#pragma unroll 8
      for (int q = 0; q < n; ++q) r += keys[q] > x;
    } else if (staged) {
      for (int s = 0; s < S; ++s) {  // entries of list s above x
        const unsigned long long* list = keys + (size_t)s * KS;
        int lo = 0, hi = KS;         // 0 past the list's end: never above
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (list[mid] > x)
            lo = mid + 1;
          else
            hi = mid;
        }
        r += lo;
      }
    } else {
      for (int s = 0; s < S; ++s) {  // entries of list s above x
        int lo = 0, hi = len(s);
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          const size_t q = (size_t)s * KS + mid;
          if (make_key(gv[q], gi[q]) > x)
            lo = mid + 1;
          else
            hi = mid;
        }
        r += lo;
      }
    }
    if (r < total) put_key(x, out_v + r, out_i + r);
  }
  for (int i = total + tid; i < k; i += NT) {
    out_v[i] = NEG_INF;
    out_i[i] = 0;
  }
}

// ------------------------------------------------------------- the plan

struct Plan {
  int S, NS, KS, staged;
  size_t slice_smem, merge_smem;
  long long ws;  // workspace bytes: the slice lists (0 when S == 1)
};

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// The slices of a row: enough to fill `sms` SMs with B rows, each between
// NS_MIN and NS_MAX docs. False for arguments the kernels do not take.
bool make_plan(int B, int n_docs, int k, int sms, Plan* p) {
  if (B < 1 || n_docs < 1 || k < 1) return false;
  const long long s_min = ceil_div(n_docs, NS_MAX);
  const long long s_max = ceil_div(n_docs, NS_MIN);
  long long S = std::max(s_min, std::min<long long>(std::max(sms / B, 1),
                                                    s_max));
  const long long NS = ceil_div(n_docs, S);
  S = ceil_div(n_docs, NS);
  if ((long long)B * S > 0x7fffffffLL) return false;
  p->S = (int)S;
  p->NS = (int)NS;
  p->KS = (int)std::min<long long>(k, NS);
  p->slice_smem = pad4(NS) * 4 + slice_fixed_bytes();
  const long long n = S * p->KS;
  p->staged = n <= MERGE_STAGE_KEYS;
  p->merge_smem = p->staged ? (size_t)n * 8 : 0;
  p->ws = S > 1 ? (long long)B * n * 8 : 0;
  return true;
}

constexpr int MAX_DEVICES = 64;

// The current device and its SM count (cached).
int current_sms(int* dev) {
  static int sms[MAX_DEVICES];
  if (cudaGetDevice(dev) != cudaSuccess) return 1;
  if (*dev < 0 || *dev >= MAX_DEVICES) return 1;
  if (sms[*dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, *dev);
    sms[*dev] = n > 0 ? n : 1;
  }
  return sms[*dev];
}

// Allow `kernel` `bytes` of dynamic shared memory on `dev` (cached: the
// allowance only grows).
template <auto kernel>
cudaError_t allow_smem(int dev, size_t bytes) {
  static size_t allowed[MAX_DEVICES];
  if (dev >= 0 && dev < MAX_DEVICES && allowed[dev] >= bytes)
    return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && dev >= 0 && dev < MAX_DEVICES) allowed[dev] = bytes;
  return e;
}

// The slice kernel for Src at k, then (S > 1) the merge kernel with NT
// threads.
template <class Src, bool kBig, int NT>
int launch(const Src& src, float* vals, int* idx, void* ws, int B,
           int n_docs, int k, const Plan& p, int dev, cudaStream_t st) {
  cudaError_t e = allow_smem<slice_kernel<Src, kBig>>(dev, p.slice_smem);
  if (e != cudaSuccess) return (int)e;
  float* lv = p.S == 1 ? vals : static_cast<float*>(ws);
  int* li = p.S == 1 ? idx
                     : reinterpret_cast<int*>(lv + (size_t)B * p.S * p.KS);
  slice_kernel<Src, kBig><<<B * p.S, THREADS, p.slice_smem, st>>>(
      src, n_docs, k, p.S, p.NS, p.KS, lv, li);
  e = cudaGetLastError();
  if (e != cudaSuccess || p.S == 1) return (int)e;
  e = allow_smem<merge_kernel<NT>>(dev, p.merge_smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B);
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = p.merge_smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, merge_kernel<NT>, (const float*)lv,
                         (const int*)li, vals, idx, p.S, p.NS, p.KS, n_docs,
                         k, p.staged);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <class Src>
int run(const Src& src, float* vals, int* idx, void* ws, int B, int n_docs,
        int k, void* stream) {
  Plan p;
  int dev = 0;
  if (!make_plan(B, n_docs, k, current_sms(&dev), &p))
    return (int)cudaErrorInvalidValue;
  if (p.S > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k <= SMALL_K)
    return launch<Src, false, MERGE_THREADS>(src, vals, idx, ws, B, n_docs,
                                             k, p, dev, st);
  return launch<Src, true, MERGE_WIDE_THREADS>(src, vals, idx, ws, B, n_docs,
                                               k, p, dev, st);
}

}  // namespace

// The device workspace every entry needs for B query rows on the current
// device, in bytes: the slices' sorted lists (0 when one slice covers the
// docs). -1 for arguments the kernels do not take.
extern "C" long long impact_topk_workspace(int B, int n_docs, int k) {
  Plan p;
  int dev = 0;
  if (!make_plan(B, n_docs, k, current_sms(&dev), &p)) return -1;
  return p.ws;
}

// C entry points, bound with ctypes. Each launches the slice kernel (and,
// with more than one slice a row, the merge kernel) on `stream` and
// returns cudaGetLastError(). All require B >= 1, n_docs >= 1 and k >= 1,
// and a workspace ws of impact_topk_workspace(B, n_docs, k) bytes (null
// when that is 0). vals f32 and idx i32 are (B, k).
//
// K4 on windows: w f32 and docs i32 are (B, W) row-major; seg_len (>= 1)
// is the lanes per query term.
extern "C" int impact_topk(const float* w, const int* docs, float* vals,
                           int* idx, void* ws, int B, int W, int seg_len,
                           int n_docs, int k, void* stream) {
  if (B < 1 || W < 0 || seg_len < 1) return (int)cudaErrorInvalidValue;
  K4Window src;
  src.s1 = make_stream(docs, 4LL * B * W);
  src.s2 = make_stream(w, 4LL * B * W);
  src.W = W;
  src.seg = seg_len;
  src.Q = (int)ceil_div(W, seg_len);
  return run(src, vals, idx, ws, B, n_docs, k, stream);
}

// K4 in place: q_idx i32 and q_val f32 are (B, Q) (vocab ids, weights);
// term_starts, term_lens i32 (V,); postings_doc i32, postings_val f32
// (P,). Terms with q_val <= 0 score nothing; an id outside [0, V) reads
// the row vocab_row gives (a negative id plus V, then clamped to [0, V -
// 1]), as the reference's gather does.
extern "C" int impact_index_topk(const int* q_idx, const float* q_val,
                                 const int* term_starts, const int* term_lens,
                                 const int* postings_doc,
                                 const float* postings_val, float* vals,
                                 int* idx, void* ws, int B, int Q, int V,
                                 long long P, int n_docs, int k,
                                 void* stream) {
  if (B < 1 || Q < 0 || V < 0 || P < 0) return (int)cudaErrorInvalidValue;
  K4Index src;
  src.q_idx = q_idx;
  src.q_val = q_val;
  src.starts = term_starts;
  src.lens = term_lens;
  src.s1 = make_stream(postings_doc, 4 * P);
  src.s2 = make_stream(postings_val, 4 * P);
  src.Q = Q;
  src.V = V;
  return run(src, vals, idx, ws, B, n_docs, k, stream);
}

// K4's tier-1 ceilings in place: the arguments of impact_index_topk with
// term_ubs f32 (V,) in place of postings_val. Each doc scores the sum, in
// term order, of c[t] = q_val[t] * term_ubs[id(t)] over the live query
// terms whose list holds it; the k best (ties to the lowest id, docs with
// a zero sum included) are written.
extern "C" int impact_ceiling_index_topk(
    const int* q_idx, const float* q_val, const int* term_starts,
    const int* term_lens, const int* postings_doc, const float* term_ubs,
    float* vals, int* idx, void* ws, int B, int Q, int V, long long P,
    int n_docs, int k, void* stream) {
  if (B < 1 || Q < 0 || V < 0 || P < 0) return (int)cudaErrorInvalidValue;
  K4Ceil src;
  src.q_idx = q_idx;
  src.q_val = q_val;
  src.starts = term_starts;
  src.lens = term_lens;
  src.ubs = term_ubs;
  src.s1 = make_stream(postings_doc, 4 * P);
  src.s2 = make_stream(postings_doc, 0);
  src.Q = Q;
  src.V = V;
  return run(src, vals, idx, ws, B, n_docs, k, stream);
}

// K5 on windows: byte_win and gap_win i32 are (B, Q, L) row-major;
// starts, lens i32 and qv, lo, step f32 are (B, Q). Q and L may be 0.
extern "C" int impact_q_topk(const int* byte_win, const int* gap_win,
                             const int* starts, const int* lens,
                             const float* qv, const float* lo,
                             const float* step, float* vals, int* idx,
                             void* ws, int B, int Q, int L, int n_docs, int k,
                             void* stream) {
  if (B < 1 || Q < 0 || L < 0) return (int)cudaErrorInvalidValue;
  K5Window src;
  src.starts = starts;
  src.lens = lens;
  src.qv = qv;
  src.lo = lo;
  src.step = step;
  src.s1 = make_stream(gap_win, 4LL * B * Q * L);
  src.s2 = make_stream(byte_win, 4LL * B * Q * L);
  src.Q = Q;
  src.L = L;
  return run(src, vals, idx, ws, B, n_docs, k, stream);
}

// K5 in place: q_idx i32 and q_val f32 are (B, Q); term_starts i32,
// term_lens (u16 when lens_u16, else i32), term_lo and term_hi f16 are
// (V,); deltas (P,) of delta_bytes (1: u8, 2: u16) each; packed_vals u8
// (n_packed,), two codes a byte, the even posting in the low nibble. The
// step is (hi - lo) * step_scale.
extern "C" int impact_q_index_topk(
    const int* q_idx, const float* q_val, const int* term_starts,
    const void* term_lens, const unsigned char* packed_vals,
    const void* deltas, const void* term_lo, const void* term_hi,
    float* vals, int* idx, void* ws, int B, int Q, int V, long long P,
    long long n_packed, int lens_u16, int delta_bytes, float step_scale,
    int n_docs, int k, void* stream) {
  if (B < 1 || Q < 0 || V < 0 || P < 0 || n_packed < 0 ||
      (delta_bytes != 1 && delta_bytes != 2))
    return (int)cudaErrorInvalidValue;
  auto go = [&](auto lens_t, auto delta_t) {
    using LensT = decltype(lens_t);
    using DeltaT = decltype(delta_t);
    K5Index<LensT, DeltaT> src;
    src.q_idx = q_idx;
    src.q_val = q_val;
    src.starts = term_starts;
    src.lens = static_cast<const LensT*>(term_lens);
    src.lo = static_cast<const __half*>(term_lo);
    src.hi = static_cast<const __half*>(term_hi);
    src.s1 = make_stream(deltas, (long long)sizeof(DeltaT) * P);
    src.s2 = make_stream(packed_vals, n_packed);
    src.step_scale = step_scale;
    src.Q = Q;
    src.V = V;
    return run(src, vals, idx, ws, B, n_docs, k, stream);
  };
  if (lens_u16)
    return delta_bytes == 1 ? go(uint16_t(), uint8_t())
                            : go(uint16_t(), uint16_t());
  return delta_bytes == 1 ? go(int32_t(), uint8_t())
                          : go(int32_t(), uint16_t());
}
