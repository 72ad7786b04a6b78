// Sparton LM-head backward for Hopper (sm_90a): K2 (dH) and K3 (dE, db).
//
// Replaces the Pallas TPU kernels src/repro/kernels/sparton_bwd.py:_dh_kernel
// (entry sparton_backward_dh) and :_de_kernel (entry sparton_backward_de).
// From the forward's saved (y, i_max) and the upstream cotangent dy, with
//
//     g[b, v] = bwd_factor(y[b, v], dy[b, v])      (the fused epilogue:
//             = y > 0 ? dy * exp(-y) * (1 - (expm1(y) / cap)^2) : 0,
//               the cap factor only under a softcap)
//
// K2 computes  dH[b, s, :] = sum_v g[b, v] * [i_max[b, v] == s] * E[v, :]
// K3 computes  dE[v, :]    = sum_b g[b, v] * H[b, i_max[b, v], :]
//              db[v]       = sum_b g[b, v]
//
// The TPU kernels turn the scatter and the gather into one-hot matmuls
// because the TPU has no atomics. Here both are done directly, and still
// without atomics: every output element is owned by one lane, which sums
// its terms as a chain of FMAs from 0 in a fixed order (ascending v for dH,
// ascending b for dE and db) and writes the element once. Two launches on
// the same inputs give the same bits, and the bits of the first CUDA
// version of these kernels, which summed in the same order. Terms with
// g == 0 (y == 0: the SPLADE rep is zero there, or the row is fully
// masked) or an i_max outside [0, S) are skipped (db still sums their g),
// so E and H are read only where a term needs them: the work scales with
// the terms where g != 0.
//
// What bounds them on the H100. Each term is one FMA per column (2 f32 FLOP)
// and needs one row of E (K2) or of H (K3), 1.5 KB in bf16 at D 768. At
// random init nearly every term has g != 0, so at the train shape (B 384,
// S 256, V 30522) each kernel gathers 18 GB of rows against a bound of
// 0.27 ms (the f32 FMAs). A row cannot be shared between the owners an SM
// holds (an owner keeps its whole D in registers, and the ~64 owners of an
// SM want different rows), so the rows come from L2 at best, and the
// design is about keeping enough of them in flight, and keeping them in
// L2, while each (b, v) input is read once.
//
// Both kernels sum from a ring in shared memory. A lane owns 8 columns of
// a piece of 256 (three pieces at D 768, so one warp owns a whole row;
// one piece where D <= 256) and copies its 16 bytes of each term's row
// with cp.async into a ring of RING_BYTES that only it reads: it issues
// the copies of the next terms while it sums the current one, with no
// register held by a copy in flight and no barrier between lanes. Rings
// of 192 bytes let 32 warps share an SM; 384 bytes (16 warps) was slower.
//
// K2 design: two kernels.
//  * route_kernel, one block per batch row b: g and the routed row s of
//    every term, then a stable counting sort of the terms with g != 0 and
//    s in [0, S) by s: ofs[b, s] .. ofs[b, s + 1] index bucket s of the
//    row's list, entries (v, g) in ascending v. Each warp sorts a
//    contiguous range of v: it counts (shared-memory atomics), the block
//    turns the counts into each warp's start in each bucket, and the warp
//    places its terms in order (the lanes of a chunk that share an s find
//    each other with __match_any_sync, and the first of them takes their
//    places from the row's cursor with one atomic). Where the row's v fit
//    beside the counts in shared memory, they are placed there and copied
//    out whole beside their g (kept in gs[b, v] meanwhile); placed
//    straight into the list, the scattered 8-byte stores cost more than
//    the rest of the pass. dy, y and i_max are read twice (count, then
//    place). Where (W + 1) * S counts do not fit shared memory, one warp
//    per row counts in place in ofs.
//  * dh_kernel, one warp per (bucket s of row b, column block): it walks
//    its bucket in ascending v through its ring (E copied with an L2
//    evict-last hint) and stores the sums once (streaming stores). One
//    warp moves about 4.5 KB at a time, so a bucket of 15k terms (a
//    trained model's [CLS] collects such) would take it milliseconds
//    alone: the routing pass lists the buckets past HEAVY terms, and the
//    first wave of blocks are helpers whose warps take them a 256-column
//    piece each (three warps a bucket at D 768, all started at once); the
//    other warps leave them. The column split keeps each element's order
//    of sums, so the bits do not depend on it.
//
// K3 design: one warp per (vocab row v, column block); a block holds VT
// vocab rows. The block walks b in ascending order in rounds of BROUND
// batch rows: its threads stage g and the routed row of the round's
// (b, v) in shared memory (read coalesced along v, stored b-fastest),
// then each warp walks the round's terms with g != 0 (ballots over 32
// rows at a time; the others add nothing to dE or db) through its ring,
// adding H-row pieces in b order; the column-0 warp of each vocab row also
// sums db. H (151 MB at the train shape) does not fit L2, so the blocks
// are launched in waves of as many as the card holds at once: the blocks
// of a wave start together and walk b together, and the rows of H they
// gather, a few batch rows' worth, stay in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int CPL = 8;           // columns of a lane's piece of a row
constexpr int PW = 32 * CPL;     // columns of a warp's piece: 256
constexpr int RING_BYTES = 192;  // a lane's ring of pieces in flight

// K2's routing pass
constexpr int ROUTE_WARPS = 32;              // warps of a row's block, at most
constexpr size_t ROUTE_SMEM = 220 * 1024;    // its counts' and list's
constexpr int AHEAD = 8;                     // chunks of 32 terms loaded at once

// K2
constexpr int DH_WARPS = 8;
constexpr int HEAVY = 1024;    // terms past which a bucket goes to helpers

// K3
constexpr int VT = 32;         // vocab rows a block owns, a warp each
constexpr int BROUND = 128;    // batch rows staged per round

// repro/kernels/_common.py:bwd_factor, in f32 and in the same order
__device__ __forceinline__ float bwd_factor(float y, float dy, int has_cap,
                                            float cap) {
  float g = dy * expf(-y);
  if (has_cap) {
    const float r = expm1f(y) / cap;
    g = g * (1.0f - r * r);
  }
  return y > 0.0f ? g : 0.0f;
}

struct Rows {  // (B, V) f32 / i32 rows of the backward's inputs
  const float* dy;
  const float* y;
  const int* imax;
  int B, S, D, V;
  int has_cap;
  float cap;
};

// The routed row of a term: its i_max where g != 0 and i_max is in [0, S)
// (an i_max outside routes nowhere, as in the reference's segment sum),
// else -1.
__device__ __forceinline__ int routed(float g, int si, int S) {
  return g != 0.0f && (unsigned)si < (unsigned)S ? si : -1;
}

// ---------------------------------------------------------------------------
// A lane's row pieces: the CPL columns at column c of a row (VEC: c .. c +
// CPL - 1, where D % 8 == 0 and the base is 16-byte aligned; else c, c +
// 32, ..., each checked against D). Each lane keeps a ring of RING_BYTES
// in shared memory for its pieces in flight, slot j % Slot::ring for the
// warp's term j: 16 bytes a term for a bf16 VEC piece, else 32 (f32).
// ---------------------------------------------------------------------------

template <typename T, bool VEC, int P>
struct Slot {
  static constexpr int words = VEC && sizeof(T) == 2 ? 1 : 2;  // a piece's
  static constexpr int ring = RING_BYTES / 16 / (P * words);  // slots
};

__device__ __forceinline__ uint64_t evict_last() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, in flight until a cp_wait; KEEP: with the
// L2 evict-last policy pol
template <bool KEEP>
__device__ __forceinline__ void cp16(void* dst, const void* src,
                                     uint64_t pol) {
  if (KEEP) {
    asm volatile(
        "cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;\n" ::"r"(
            smem_u32(dst)),
        "l"(src), "l"(pol)
        : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest N of this thread has landed
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void bf16x8(uint4 q, float* out) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h2[j]);
    out[2 * j] = f.x;
    out[2 * j + 1] = f.y;
  }
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// The lane's piece of `row` into its slot (words slot[0], slot[32]): VEC
// by cp.async, else loaded and stored as f32 at once.
template <typename T, bool VEC, bool KEEP>
__device__ __forceinline__ void to_slot(uint4* slot, const T* row, int c,
                                        int D, uint64_t pol) {
  if (VEC) {
    if (c < D) {
#pragma unroll
      for (int q = 0; q < Slot<T, VEC, 1>::words; ++q)
        cp16<KEEP>(slot + 32 * q,
                   reinterpret_cast<const char*>(row + c) + 16 * q, pol);
    }
  } else {
    float x[CPL];
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      x[k] = c + 32 * k < D ? to_f32(row[c + 32 * k]) : 0.0f;
    slot[0] = make_uint4(__float_as_uint(x[0]), __float_as_uint(x[1]),
                         __float_as_uint(x[2]), __float_as_uint(x[3]));
    slot[32] = make_uint4(__float_as_uint(x[4]), __float_as_uint(x[5]),
                          __float_as_uint(x[6]), __float_as_uint(x[7]));
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void from_slot(const uint4* slot, float* out) {
  if (Slot<T, VEC, 1>::words == 1) {
    bf16x8(slot[0], out);
  } else {
    const uint4 a = slot[0];
    const uint4 b = slot[32];
    out[0] = __uint_as_float(a.x);
    out[1] = __uint_as_float(a.y);
    out[2] = __uint_as_float(a.z);
    out[3] = __uint_as_float(a.w);
    out[4] = __uint_as_float(b.x);
    out[5] = __uint_as_float(b.y);
    out[6] = __uint_as_float(b.z);
    out[7] = __uint_as_float(b.w);
  }
}

template <bool VEC>
__device__ __forceinline__ void store_row(float* row, int c, int D,
                                          const float* acc) {
  if (VEC) {
    if (c < D) {
      __stcs(reinterpret_cast<float4*>(row + c),
             make_float4(acc[0], acc[1], acc[2], acc[3]));
      __stcs(reinterpret_cast<float4*>(row + c + 4),
             make_float4(acc[4], acc[5], acc[6], acc[7]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      if (c + 32 * k < D) __stcs(row + c + 32 * k, acc[k]);
  }
}

// ---------------------------------------------------------------------------
// K2, routing pass
// ---------------------------------------------------------------------------

// a[0 .. n) replaced by its exclusive prefix sums, by the whole block
// (blockDim.x a multiple of 32); a may lie in shared or global memory
__device__ void block_exclusive_scan(int* a, int n) {
  __shared__ int warp_sum[32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int seg = (n + blockDim.x - 1) / blockDim.x;
  const int lo = min(n, (int)threadIdx.x * seg);
  const int hi = min(n, lo + seg);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int x = sum;  // inclusive prefix over the warp's lanes
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += t;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < (int)blockDim.x / 32 ? warp_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += t;
    }
    warp_sum[lane] = w;
  }
  __syncthreads();
  int run = x - sum + (warp > 0 ? warp_sum[warp - 1] : 0);
  for (int i = lo; i < hi; ++i) {
    const int c = a[i];
    a[i] = run;
    run += c;
  }
  __syncthreads();
}

// One block of W warps per batch row. SMEM: the (W, S) counts (and, for
// W > 1, the S row totals) in shared memory; else W == 1 and the counts
// live in ofs[b, 1 ..] itself.
template <bool SMEM, bool STAGE>
__global__ void __launch_bounds__(ROUTE_WARPS * 32) route_kernel(Rows r, int* __restrict__ ofs,
                             int2* __restrict__ list, float* __restrict__ gs,
                             int* __restrict__ heavy) {
  extern __shared__ int smem[];
  const int W = blockDim.x / 32;
  const int b = blockIdx.x;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = (size_t)b * r.V;
  int* ofs_row = ofs + (size_t)b * (r.S + 1);
  int* table = SMEM ? smem : ofs_row + 1;                // (W, S)
  int* tot = SMEM && W > 1 ? smem + (size_t)W * r.S : table;  // (S,)
  // STAGE: the v of the row's list are placed in shared memory, then
  // copied out whole beside their g (placed straight into the list, the
  // scattered 8-byte stores cost more than the rest of the pass)
  int* place = STAGE ? smem + (size_t)(W + (W > 1)) * r.S : nullptr;
  for (int i = threadIdx.x; i < W * r.S; i += blockDim.x) table[i] = 0;
  __syncthreads();

  const int per = ((r.V + W - 1) / W + 31) / 32 * 32;
  const int v_lo = min(r.V, warp * per);
  const int v_hi = min(r.V, v_lo + per);
  int* mine = table + (size_t)warp * r.S;
  const unsigned lower = (1u << lane) - 1;

  // pass 0 counts each routed row's terms in this warp's range; pass 1
  // places them (ascending v: the warp's chunks in order, and within a
  // chunk the lanes in order, ranked among the lanes of their row with
  // __match_any_sync)
  for (int pass = 0; pass < 2; ++pass) {
    for (int v0 = v_lo; v0 < v_hi; v0 += 32 * AHEAD) {
      float g[AHEAD];
      int s[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int v = v0 + 32 * u + lane;
        g[u] = 0.0f;
        s[u] = -1;
        if (v < v_hi) {
          g[u] = bwd_factor(r.y[row + v], r.dy[row + v], r.has_cap, r.cap);
          s[u] = routed(g[u], r.imax[row + v], r.S);
        }
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (pass == 0) {  // counts: the order of the additions is free
          if (s[u] >= 0) atomicAdd(mine + s[u], 1);
          continue;
        }
        // the lanes of each row: the first takes their places from the
        // row's cursor (an atomic, so that no barrier orders the cursor's
        // reads and writes across chunks) and passes its start on
        const unsigned peers = __match_any_sync(FULL, s[u]);
        const int first = __ffs(peers) - 1;
        int start = 0;
        if (s[u] >= 0 && lane == first)
          start = atomicAdd(mine + s[u], __popc(peers));
        start = __shfl_sync(FULL, start, first);
        const int at = start + __popc(peers & lower);
        const int v = v0 + 32 * u + lane;
        if (s[u] >= 0) {
          if (STAGE) {
            place[at] = v;
            gs[row + v] = g[u];
          } else {
            list[row + at] = make_int2(v, __float_as_int(g[u]));
          }
        }
      }
    }
    __syncthreads();
    if (pass == 1) break;
    // counts -> where each warp's share of each bucket starts
    if (W > 1) {
      for (int s = threadIdx.x; s < r.S; s += blockDim.x) {
        int run = 0;
        for (int w = 0; w < W; ++w) {
          const int c = table[w * r.S + s];
          table[w * r.S + s] = run;
          run += c;
        }
        tot[s] = run;
      }
      __syncthreads();
    }
    // buckets past HEAVY terms go to the helper warps: appended to
    // heavy[2 ..] as (b, s) pairs, heavy[0] counting them, in no fixed
    // order (each one's sums have one)
    for (int s = threadIdx.x; s < r.S; s += blockDim.x)
      if (tot[s] > HEAVY)
        reinterpret_cast<int2*>(heavy + 2)[atomicAdd(heavy, 1)] =
            make_int2(b, s);
    block_exclusive_scan(tot, r.S);
    if (W > 1) {
      for (int i = threadIdx.x; i < W * r.S; i += blockDim.x)
        table[i] += tot[i % r.S];
      __syncthreads();
    }
  }
  // the last warp's cursors now stand at each bucket's end
  const int* last = table + (size_t)(W - 1) * r.S;
  if (SMEM) {
    for (int s = threadIdx.x; s < r.S; s += blockDim.x)
      ofs_row[s + 1] = last[s];
  }
  if (threadIdx.x == 0) ofs_row[0] = 0;
  if (STAGE) {
    const int n = last[r.S - 1];
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int v = place[i];
      list[row + i] = make_int2(v, __float_as_int(gs[row + v]));
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dH
// ---------------------------------------------------------------------------

// A warp's share of a row: P pieces of PW columns, piece p at column
// c0 + p * PW; its lane's columns start at piece_col(...) (VEC: 8 in a
// row; else every 32nd). Slot layout: (slot, piece, word, lane).
template <bool VEC>
__device__ __forceinline__ int piece_col(int c0, int p, int lane) {
  return c0 + p * PW + (VEC ? lane * CPL : lane);
}

// One warp's walk of a bucket's n terms (entries (v, g) in ascending v)
// through a ring of R slots: issue(v, slot) starts the copies of a term's
// row into a slot, sum(g, slot) adds a landed slot times g.
template <int R, class Issue, class Sum>
__device__ __forceinline__ void walk(const int2* __restrict__ terms, int n,
                                     int lane, Issue issue, Sum sum) {
  // entries [base, base + 96), a window of three registers (lane l holds
  // entries base + l, base + 32 + l, base + 64 + l); the third is loaded
  // 32 terms before it is needed
  auto load = [&](int k) { return k < n ? terms[k] : make_int2(0, 0); };
  int base = 0;
  int2 w0 = load(lane);
  int2 w1 = load(32 + lane);
  int2 w2 = load(64 + lane);
  auto entry = [&](int j, bool want_g) {  // warp-uniform j
    const int d = j - base;
    const int2 w = d < 32 ? w0 : d < 64 ? w1 : w2;
    return __shfl_sync(FULL, want_g ? w.y : w.x, d & 31);
  };
  auto start = [&](int j) {
    const int v = entry(j, false);
    if (j < n) issue(v, j % R);
    cp_commit();
  };
  for (int j = 0; j < R - 1; ++j) start(j);
  for (int j = 0; j < n; ++j) {  // ascending v
    if (j + R - 1 - base >= 96) {
      base += 32;
      w0 = w1;
      w1 = w2;
      w2 = load(base + 64 + lane);
    }
    start(j + R - 1);
    cp_wait<R - 1>();  // this lane's copies of term j have landed
    sum(__int_as_float(entry(j, true)), j % R);
  }
  cp_wait<0>();
}

// One warp sums bucket s of row b for its column block c (P pieces of PW
// columns a lane) through its ring, and stores the sums.
template <typename T, bool VEC, int P>
__device__ __forceinline__ void sum_bucket(const T* __restrict__ E,
                                           float* __restrict__ dH,
                                           const int2* __restrict__ list,
                                           const Rows& r, int b, int s, int c,
                                           int lo, int n, int lane,
                                           uint4* slots, uint64_t pol) {
  constexpr int R = Slot<T, VEC, P>::ring;
  constexpr int SW = Slot<T, VEC, P>::words;
  const int c0 = c * P * PW;
  const bool live = piece_col<VEC>(c0, 0, lane) < r.D;
  float acc[P][CPL];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[p][k] = 0.0f;
  walk<R>(
      list + (size_t)b * r.V + lo, n, lane,
      [&](int v, int slot) {  // the term's pieces of its row of E
        if (!live) return;
#pragma unroll
        for (int p = 0; p < P; ++p)
          to_slot<T, VEC, true>(slots + (slot * P + p) * SW * 32,
                                E + (size_t)v * r.D,
                                piece_col<VEC>(c0, p, lane), r.D, pol);
      },
      [&](float g, int slot) {
        if (!live) return;
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float e[CPL];
          from_slot<T, VEC>(slots + (slot * P + p) * SW * 32, e);
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[p][k] += g * e[k];
        }
      });
  float* out = dH + ((size_t)b * r.S + s) * r.D;
#pragma unroll
  for (int p = 0; p < P; ++p)
    store_row<VEC>(out, piece_col<VEC>(c0, p, lane), r.D, acc[p]);
}

// The first helper_blocks blocks are helpers: their warps sum the heavy
// buckets (more than HEAVY terms, listed by the routing pass) a piece of
// 256 columns each, so that three warps (at D 768) share one. The other
// warps sum one bucket each for P pieces, in (s, b, column block) order,
// and leave the heavy ones to the helpers.
template <typename T, bool VEC, int P>
__global__ void __launch_bounds__(DH_WARPS * 32)
    dh_kernel(const T* __restrict__ E, float* __restrict__ dH,
              const int* __restrict__ ofs, const int2* __restrict__ list,
              const int* __restrict__ heavy, Rows r, int nc,
              int helper_blocks) {
  extern __shared__ uint4 rings[];  // (DH_WARPS, RING_BYTES / 16, 32)
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  uint4* slots = rings + (size_t)warp * (RING_BYTES / 16) * 32 + lane;
  const uint64_t pol = evict_last();

  if ((int)blockIdx.x < helper_blocks) {
    const int pieces = (r.D + PW - 1) / PW;
    const long long items = (long long)heavy[0] * pieces;
    const int2* buckets = reinterpret_cast<const int2*>(heavy + 2);
    for (long long it = (long long)blockIdx.x * DH_WARPS + warp; it < items;
         it += (long long)helper_blocks * DH_WARPS) {
      const int2 bs = buckets[it / pieces];
      const int lo = ofs[(size_t)bs.x * (r.S + 1) + bs.y];
      const int n = ofs[(size_t)bs.x * (r.S + 1) + bs.y + 1] - lo;
      sum_bucket<T, VEC, 1>(E, dH, list, r, bs.x, bs.y,
                            (int)(it % pieces), lo, n, lane, slots, pol);
    }
    return;
  }

  const long long item =
      (long long)(blockIdx.x - helper_blocks) * DH_WARPS + warp;
  if (item >= (long long)r.S * r.B * nc) return;
  const int c = (int)(item % nc);  // (s, b, c) order
  const long long sb = item / nc;
  const int b = (int)(sb % r.B);
  const int s = (int)(sb / r.B);
  const int lo = ofs[(size_t)b * (r.S + 1) + s];
  const int n = ofs[(size_t)b * (r.S + 1) + s + 1] - lo;
  if (helper_blocks > 0 && n > HEAVY) return;  // a helpers' bucket
  sum_bucket<T, VEC, P>(E, dH, list, r, b, s, c, lo, n, lane, slots, pol);
}

// ---------------------------------------------------------------------------
// K3: dE and db
// ---------------------------------------------------------------------------

// A block of VT warps, warp w owning vocab row tile * VT + w and the
// columns of column block blockIdx.y; the wave's first tile is tile0.
template <typename T, bool VEC, int P>
__global__ void __launch_bounds__(VT * 32)
    de_kernel(const T* __restrict__ H, float* __restrict__ dE,
              float* __restrict__ db, Rows r, int tile0) {
  constexpr int R = Slot<T, VEC, P>::ring;
  constexpr int SW = Slot<T, VEC, P>::words;
  // the round's g and routed row (or -1) of each vocab row, b fastest
  __shared__ float g_round[VT][BROUND];
  __shared__ int s_round[VT][BROUND];
  extern __shared__ uint4 rings[];  // (VT, R, P, SW, 32)
  const int vl = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int v0 = (tile0 + blockIdx.x) * VT;
  const int v = v0 + vl;
  const int c0 = blockIdx.y * P * PW;
  const bool live = piece_col<VEC>(c0, 0, lane) < r.D;
  uint4* slots = rings + (size_t)vl * R * P * SW * 32 + lane;
  const float* g_mine = g_round[vl];
  const int* s_mine = s_round[vl];

  float acc[P][CPL];
#pragma unroll
  for (int p = 0; p < P; ++p)
#pragma unroll
    for (int k = 0; k < CPL; ++k) acc[p][k] = 0.0f;
  float db_sum = 0.0f;
  for (int b0 = 0; b0 < r.B; b0 += BROUND) {
    const int nb = min(BROUND, r.B - b0);
    __syncthreads();  // the last round is consumed
#pragma unroll 4
    for (int k = threadIdx.x; k < nb * VT; k += blockDim.x) {
      const int bi = k / VT;  // coalesced along v
      const int vv = k % VT;
      float g = 0.0f;
      int si = -1;
      if (v0 + vv < r.V) {
        const size_t bv = (size_t)(b0 + bi) * r.V + v0 + vv;
        g = bwd_factor(__ldcs(r.y + bv), __ldcs(r.dy + bv), r.has_cap,
                       r.cap);
        si = __ldcs(r.imax + bv);
      }
      g_round[vv][bi] = g;
      s_round[vv][bi] = routed(g, si, r.S);
    }
    __syncthreads();

    // The round's terms with g != 0 (the others add nothing, to dE or to
    // db), in ascending b: a cursor is (first row of its chunk of 32, the
    // chunk's rows not taken yet).
    auto next = [&](int& chunk, unsigned& left) {  // -1 past the round
      while (left == 0) {
        chunk += 32;
        if (chunk >= nb) return -1;
        left = __ballot_sync(FULL, chunk + lane < nb &&
                                       g_mine[chunk + lane] != 0.0f);
      }
      const int bi = chunk + __ffs(left) - 1;
      left &= left - 1;
      return bi;
    };
    auto issue = [&](int bi, int slot) {  // row b0 + bi's pieces of H
      if (bi >= 0 && live && s_mine[bi] >= 0) {
        const T* row = H + ((size_t)(b0 + bi) * r.S + s_mine[bi]) * r.D;
#pragma unroll
        for (int p = 0; p < P; ++p)
          to_slot<T, VEC, false>(slots + (slot * P + p) * SW * 32, row,
                                 piece_col<VEC>(c0, p, lane), r.D, 0);
      }
      cp_commit();
    };
    int ic = -32, cc = -32;  // the issuing and the summing cursor
    unsigned il = 0, cl = 0;
    for (int t = 0; t < R - 1; ++t) issue(next(ic, il), t);
    for (int t = 0;; ++t) {  // ascending b
      const int bi = next(cc, cl);
      if (bi < 0) break;
      issue(next(ic, il), (t + R - 1) % R);
      const float g = g_mine[bi];
      db_sum += g;
      if (live && s_mine[bi] >= 0) {
        cp_wait<R - 1>();  // this lane's pieces of row bi have landed
#pragma unroll
        for (int p = 0; p < P; ++p) {
          float h[CPL];
          from_slot<T, VEC>(slots + ((t % R) * P + p) * SW * 32, h);
#pragma unroll
          for (int k = 0; k < CPL; ++k) acc[p][k] += g * h[k];
        }
      }
    }
    cp_wait<0>();
  }

  if (v >= r.V) return;
  float* out = dE + (size_t)v * r.D;
#pragma unroll
  for (int p = 0; p < P; ++p)
    store_row<VEC>(out, piece_col<VEC>(c0, p, lane), r.D, acc[p]);
  if (blockIdx.y == 0 && lane == 0) db[v] = db_sum;
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The routing pass's shape: its warps per row (the most, up to
// ROUTE_WARPS, whose counts fit), and whether its counts (smem) and the
// row's list (stage) are kept in shared memory: the list too where it
// fits beside one warp's counts, else the counts alone, else neither (one
// warp a row then counts in ofs).
struct RoutePlan {
  int warps;
  bool smem, stage;
  size_t bytes;
};

RoutePlan route_plan(int S, int V) {
  for (int stage = 1; stage >= 0; --stage) {
    const size_t list = stage ? (size_t)V * sizeof(int) : 0;
    for (int w = ROUTE_WARPS; w >= 1 && list <= ROUTE_SMEM; w /= 2) {
      const size_t bytes = list + (size_t)(w + (w > 1)) * S * sizeof(int);
      if (bytes <= ROUTE_SMEM) return {w, true, stage == 1, bytes};
    }
  }
  return {1, false, false, 0};
}

template <bool SMEM, bool STAGE>
int launch_route_as(const RoutePlan& p, Rows r, int* ofs, int2* list,
                    float* gs, int* heavy, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      route_kernel<SMEM, STAGE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)p.bytes);
  if (err != cudaSuccess) return (int)err;
  route_kernel<SMEM, STAGE><<<r.B, p.warps * 32, p.bytes, stream>>>(
      r, ofs, list, gs, heavy);
  return (int)cudaGetLastError();
}

int launch_route(Rows r, int* ofs, int2* list, float* gs, int* heavy,
                 cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(heavy, 0, sizeof(int), stream);
  if (err != cudaSuccess) return (int)err;
  const RoutePlan p = route_plan(r.S, r.V);
  if (!p.smem)
    return launch_route_as<false, false>(p, r, ofs, list, gs, heavy, stream);
  if (!p.stage)
    return launch_route_as<true, false>(p, r, ofs, list, gs, heavy, stream);
  return launch_route_as<true, true>(p, r, ofs, list, gs, heavy, stream);
}

// a block's rings: RING_BYTES for each of its lanes
constexpr size_t ring_smem(int warps) {
  return (size_t)warps * 32 * RING_BYTES;
}

// Pieces a lane takes of a row: three (768 columns a warp, D 768 in one
// warp) where D is past one piece, else one.
int pieces(int D) { return D > PW ? 3 : 1; }

template <typename T, bool VEC, int P>
int launch_dh(const void* E, float* dH, int* ofs, int2* list, float* gs,
              int* heavy, Rows r, cudaStream_t stream) {
  cudaError_t err = (cudaError_t)launch_route(r, ofs, list, gs, heavy, stream);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_smem(DH_WARPS);
  err = cudaFuncSetAttribute(dh_kernel<T, VEC, P>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  // helpers: the whole first wave of blocks, so that every heavy bucket's
  // warps start at once (blocks with no heavy piece to take end at once)
  int dev = 0, sms = 0, per_sm = 0, helper_blocks = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, dh_kernel<T, VEC, P>, DH_WARPS * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (P > 1) helper_blocks = per_sm * sms;
  const int nc = (r.D + P * PW - 1) / (P * PW);
  const long long warps = (long long)r.S * r.B * nc;
  const long long blocks = (warps + DH_WARPS - 1) / DH_WARPS + helper_blocks;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dh_kernel<T, VEC, P><<<(unsigned)blocks, DH_WARPS * 32, smem, stream>>>(
      static_cast<const T*>(E), dH, ofs, list, heavy, r, nc, helper_blocks);
  return (int)cudaGetLastError();
}

// Waves of the blocks the card holds at once; each wave's blocks cover
// the column blocks (grid.y) of consecutive vocab tiles.
template <typename T, bool VEC, int P>
int launch_de(const void* H, float* dE, float* db, Rows r,
              cudaStream_t stream) {
  const int nc = (r.D + P * PW - 1) / (P * PW);
  const size_t smem = ring_smem(VT);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaFuncSetAttribute(
      de_kernel<T, VEC, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, de_kernel<T, VEC, P>, VT * 32, smem);
  if (err != cudaSuccess) return (int)err;
  if (nc > 65535) return (int)cudaErrorInvalidValue;
  const int wave = per_sm * sms / nc > 0 ? per_sm * sms / nc : 1;
  const int tiles = (r.V + VT - 1) / VT;
  for (int t0 = 0; t0 < tiles; t0 += wave) {
    dim3 grid(tiles - t0 < wave ? tiles - t0 : wave, nc);
    de_kernel<T, VEC, P><<<grid, VT * 32, smem, stream>>>(
        static_cast<const T*>(H), dE, db, r, t0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

template <typename T, bool VEC>
int launch_dh(const void* E, float* dH, int* ofs, int2* list, float* gs,
              int* heavy, Rows r, cudaStream_t stream) {
  return pieces(r.D) == 3
             ? launch_dh<T, VEC, 3>(E, dH, ofs, list, gs, heavy, r, stream)
             : launch_dh<T, VEC, 1>(E, dH, ofs, list, gs, heavy, r, stream);
}

template <typename T, bool VEC>
int launch_de(const void* H, float* dE, float* db, Rows r,
              cudaStream_t stream) {
  return pieces(r.D) == 3 ? launch_de<T, VEC, 3>(H, dE, db, r, stream)
                          : launch_de<T, VEC, 1>(H, dE, db, r, stream);
}

Rows make_rows(const float* dy, const float* y, const int* imax, int B, int S,
               int D, int V, float softcap) {
  Rows r;
  r.dy = dy;
  r.y = y;
  r.imax = imax;
  r.B = B;
  r.S = S;
  r.D = D;
  r.V = V;
  r.has_cap = softcap > 0.0f;
  r.cap = softcap;
  return r;
}

bool bad_shape(int B, int S, int D, int V) {
  return B < 1 || S < 1 || D < 1 || V < 1;
}

}  // namespace

// C entry points, bound with ctypes. dy, y f32 (B, V); imax i32 (B, V);
// dtype: 0 = float32, 1 = bfloat16 (of E, resp. H). softcap <= 0 means no
// cap. vec: 16-byte loads of 8-column pieces (the wrapper sets it when D is
// a multiple of 8 and the weights' base is 16-byte aligned). Each returns
// the first CUDA error of its launches.

// K2: dH f32 (B, S, D). ofs i32 (B, S + 1), list (B, V) of (i32 v, f32 g)
// pairs, gs f32 (B, V) and heavy i32 (2 + 2 * B * min(S, V): a count, a
// pad, then (b, s) pairs) are the routing pass's scratch, which the
// wrapper allocates.
extern "C" int sparton_bwd_dh(const float* dy, const float* y, const int* imax,
                              const void* E, float* dH, int* ofs, void* list,
                              float* gs, int* heavy, int B, int S, int D,
                              int V, int dtype, float softcap, int vec,
                              void* stream) {
  if (bad_shape(B, S, D, V)) return (int)cudaErrorInvalidValue;
  const Rows r = make_rows(dy, y, imax, B, S, D, V, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int2* l = static_cast<int2*>(list);
  if (dtype == 1) {
    return vec ? launch_dh<__nv_bfloat16, true>(E, dH, ofs, l, gs, heavy, r,
                                                st)
               : launch_dh<__nv_bfloat16, false>(E, dH, ofs, l, gs, heavy, r,
                                                 st);
  }
  if (dtype == 0) {
    return vec ? launch_dh<float, true>(E, dH, ofs, l, gs, heavy, r, st)
               : launch_dh<float, false>(E, dH, ofs, l, gs, heavy, r, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K3: dE f32 (V, D), db f32 (V,).
extern "C" int sparton_bwd_de(const float* dy, const float* y, const int* imax,
                              const void* H, float* dE, float* db, int B,
                              int S, int D, int V, int dtype, float softcap,
                              int vec, void* stream) {
  if (bad_shape(B, S, D, V)) return (int)cudaErrorInvalidValue;
  const Rows r = make_rows(dy, y, imax, B, S, D, V, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return vec ? launch_de<__nv_bfloat16, true>(H, dE, db, r, st)
               : launch_de<__nv_bfloat16, false>(H, dE, db, r, st);
  }
  if (dtype == 0) {
    return vec ? launch_de<float, true>(H, dE, db, r, st)
               : launch_de<float, false>(H, dE, db, r, st);
  }
  return (int)cudaErrorInvalidValue;
}
