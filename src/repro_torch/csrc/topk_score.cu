// Dense scoring with a streaming top-k for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_score.py:_topk_kernel
// (entry topk_score). For queries q (B, D) and candidates C (N, D), both f32
// and row-major, it returns per query row the k best of
//
//     score[b, n] = sum over d of q[b, d] * C[n, d]
//
// ordered by value descending, then candidate id ascending, without writing
// the (B, N) score matrix to device memory. Any k >= 1: when k > N the
// columns past N hold (NEG_INF, 0), as in the reference.
//
// Design. The Pallas grid walks the candidates in order on one core, with
// the running top-k carried in the output block; translated block for
// block it would stream the whole corpus through one SM at the serving
// batch. Here the candidates are cut into tiles and the tiles into G
// contiguous ranges, G chosen from how many blocks fit on the 132 SMs.
// Pass 1 gives each block one range and a group of query rows, forms each
// tile's scores, and merges them into a running top-k per query row; at the
// end it writes its kp = min(k, candidates in its range) best per row to a
// partial buffer. Pass 2 (merge_kernel) merges the G partial lists of each
// query row into the k best.
//
// Pass 1 has two forms.
//
// Small batches (B <= 8, what the dense serve path sends) take
// stream_kernel: bytes bound it (C is read once, 2.0 GB at N = 16384,
// D = 30522: 0.60 ms at 3.35 TB/s, against 0.12 ms of f32 FMAs). Each warp
// reads 4 candidate rows straight from device memory, 64 contiguous floats
// of a row per load, with 4 such loads of every row issued before their
// FMAs so that enough bytes are in flight; the queries are staged through
// shared memory. Scores are f32 FMAs, one chain per lane in ascending d,
// the lanes added in a fixed butterfly.
//
// Larger batches take wg_kernel. No entry point of the port sends K6 more
// than 8 queries yet (the serve CLI retrieves for 8 served queries; its
// batches of up to 16 are encode batches, which run K1): only a direct
// caller of retrieve/topk_score with B > 8 reaches it. At B = 64 the f32
// FMAs alone need 0.96 ms at the 67 TFLOP/s f32 peak, which a SIMT GEMM
// reaches only in part (the 8 x 4 register tile this replaced ran at a
// third of it, slower than cuBLAS + topk).
// Plain TF32 tensor cores round the inputs to 10 mantissa bits and move
// ids, so wg_kernel takes split f32 (3xTF32) on wgmma: three TF32 products
// per f32 one, about f32's rounding in all (see wg_kernel's note), 0.39 ms
// of tensor-core time at B = 64 at the 495 TFLOP/s TF32 peak, so that
// reading C (0.60 ms) bounds it. Why this layout:
// - mma.sync m16n8k8 TF32 runs far below the TF32 peak on Hopper: with it
//   the three products alone took longer than cuBLAS's f32 GEMM.
// - C, the large operand, is read in place (a row of 30522 floats is
//   8-byte but not 16-byte aligned: TMA cannot describe it) straight into
//   the registers wgmma takes its A operand from, two slices ahead, and
//   split there. Staging it through shared memory with cp.async cost more
//   than it hid: the copies and the products of a slice overlapped only
//   in part.
// - The queries, the small operand, are split once per call into wgmma's
//   shared-memory layout, and a ring of slots of two slices each feeds
//   them, one barrier per slot.
// - A block owns 16, 32 or 64 query rows (wgmma's N) against 128
//   candidates (two warpgroups of M = 64): 128 blocks at N = 16384, one an
//   SM.
// - The tensor cores' accumulation keeps fewer bits than a rounded f32
//   add, so the products are taken over into an f32 sum once per slice.
//
// The running lists. A merge step places each entry at its rank under the
// strict order (value desc, id asc) among the union of the running list
// and the new entries. The lists of a block (two of kp entries per query
// row) live in shared memory while they fit; for a larger k they live in a
// slice of the workspace that only that block touches, so k has no limit
// beyond device memory. Pass 2's lists likewise.
//
// Determinism. Each score is the same sequence of FMAs or MMAs in ascending
// d for every candidate and every launch; a merge keeps the k best of a set
// whatever the order of the tiles, ranges or chunks. Two launches give the
// same bits, and no atomics are used.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int CHUNK = 256;         // partial entries merged per step (pass 2)
constexpr int MERGE_THREADS = CHUNK;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr size_t SMEM_SM = 233472;   // shared memory of one SM
constexpr size_t WS_ALIGN = 256;     // alignment of the workspace's buffers
constexpr float NEG_INF = -1e30f;

// The strict order of the result: value descending, then id ascending.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool in) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
               "l"(src), "n"(BYTES), "r"(in ? BYTES : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Two running lists of `cap` entries for each of `rows` query rows: the
// current one (rv, ri) and the next (nv, ni), swapped after each merge.
struct Lists {
  float* rv;
  int* ri;
  float* nv;
  int* ni;
  __device__ __forceinline__ void swap() {
    float* v = rv;
    rv = nv;
    nv = v;
    int* i = ri;
    ri = ni;
    ni = i;
  }
};

__device__ __forceinline__ Lists carve_lists(float* base, int rows, int cap) {
  const size_t n = (size_t)rows * cap;
  Lists l;
  l.rv = base;
  l.ri = reinterpret_cast<int*>(base + n);
  l.nv = base + 2 * n;
  l.ni = reinterpret_cast<int*>(base + 3 * n);
  return l;
}

// One merge step for `rows` rows, block-wide. Row r's running list (L.rv,
// L.ri at r * cap: `len` entries, best first) takes in the row's new
// entries (tv[r * ldt + j], ids[j]) for j < cols, an id < 0 marking an
// empty entry; the best cap of the union go, best first, to (L.nv, L.ni).
// Each entry lands at its rank in the union: the running entries better
// than it (a binary search) plus the new entries better than it (a count).
// A new entry that cannot beat a full list's last entry is skipped.
__device__ __forceinline__ void merge_step(int rows, int cols, const float* tv,
                                           int ldt, const int* ids,
                                           const Lists& L, int len, int cap) {
  for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
    const int r = p / cols, j = p % cols;
    const int xi = ids[j];
    if (xi < 0) continue;
    const float x = tv[r * ldt + j];
    const float* rrv = L.rv + (size_t)r * cap;
    const int* rri = L.ri + (size_t)r * cap;
    if (len == cap && !better(x, xi, rrv[cap - 1], rri[cap - 1])) continue;
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (better(rrv[mid], rri[mid], x, xi))
        lo = mid + 1;
      else
        hi = mid;
    }
    int pos = lo;
    for (int jj = 0; jj < cols && pos < cap; ++jj) {
      const int yi = ids[jj];
      pos += yi >= 0 && better(tv[r * ldt + jj], yi, x, xi);
    }
    if (pos < cap) {
      L.nv[(size_t)r * cap + pos] = x;
      L.ni[(size_t)r * cap + pos] = xi;
    }
  }
  for (int p = threadIdx.x; p < rows * len; p += blockDim.x) {
    const int r = p / len, at = p % len;
    const float z = L.rv[(size_t)r * cap + at];
    const int zi = L.ri[(size_t)r * cap + at];
    int pos = at;
    for (int jj = 0; jj < cols && pos < cap; ++jj) {
      const int yi = ids[jj];
      pos += yi >= 0 && better(tv[r * ldt + jj], yi, z, zi);
    }
    if (pos < cap) {
      L.nv[(size_t)r * cap + pos] = z;
      L.ni[(size_t)r * cap + pos] = zi;
    }
  }
}

// A block's kp best per row, padded with (NEG_INF, -1), to
// part[((b0 + r) * G + g) * kp + .].
__device__ __forceinline__ void write_partial(const Lists& L, int len, int kp,
                                              int rows, int b0,
                                              float* part_v, int* part_i) {
  for (int e = threadIdx.x; e < rows * kp; e += blockDim.x) {
    const int r = e / kp, p = e % kp;
    const size_t o = ((size_t)(b0 + r) * gridDim.x + blockIdx.x) * kp + p;
    part_v[o] = p < len ? L.rv[(size_t)r * kp + p] : NEG_INF;
    part_i[o] = p < len ? L.ri[(size_t)r * kp + p] : -1;
  }
}

// ---------------------------------------------------------------------------
// Pass 1 for B > 8: 3xTF32 on the tensor cores (wgmma)
// ---------------------------------------------------------------------------

// A block is two warpgroups; warpgroup w scores candidates n0 + 64 w ..
// + 64 of a tile against the block's BQ query rows with wgmma m64nBQk8 on
// split f32 (3xTF32): each operand x = hi + lo, hi the TF32 rounding of x
// and lo the TF32 rounding of x - hi (exact in f32), and per k8 step of d
//
//   score += lo_C * hi_q + hi_C * lo_q + hi_C * hi_q
//
// with f32 accumulation (the small products first), the accumulators
// added into a rounded f32 sum once per 32-wide slice. The dropped
// lo_C * lo_q and the roundings of lo are about 2^-22 of each product,
// f32's own rounding; inputs exact in TF32 (small integers) have lo = 0
// and exact sums.
// A = the candidate rows, loaded by each thread straight from device
// memory into registers (two slices ahead) and split there: wgmma's
// register fragment holds rows g and g + 8 of the warp's 16 and columns t
// and t + 4 of a k8 step, and since any order of d gives the same products
// the thread's 8 neighbouring columns 8 t .. 8 t + 7 of a 32-wide slice
// are dealt to the slice's 4 steps a pair each, so that its loads are 8
// bytes wide and a warp reads 128 contiguous bytes of each of its rows.
// B = the queries, split once per call and laid out, in the same order of
// d, as wgmma's K-major core matrices (8 rows of 16 bytes, no swizzle), so
// that a ring slot (two slices) is filled with 16-byte cp.async copies.
template <int BQ_>
struct Wg {
  static constexpr int BQ = BQ_, BN = 128, TD = 32, STAGES = 4;
  static constexpr int QS = 2;             // slices of queries a ring slot
  static constexpr int BM = BQ;            // query rows a block (the plan's)
  static constexpr int THREADS = 256;      // two warpgroups
  static constexpr int Q_ELEMS = BQ * TD;  // one TF32 half of the queries
  static constexpr int STAGE = 2 * QS * Q_ELEMS;
  static constexpr int KSTEPS = TD / 8;
  static constexpr int NACC = BQ / 2;      // accumulators a thread
  static constexpr int LDS = BN + 8;       // the score tile's rows (queries)
  static_assert(BQ == 16 || BQ == 32 || BQ == 64, "wgmma N");
  static_assert(BQ * LDS <= STAGES * STAGE, "the score tile aliases the ring");
  static size_t ring_bytes() {  // the ring, then the tile's ids
    return (size_t)(STAGES * STAGE + BN) * sizeof(float);
  }
};
using Wg16 = Wg<16>;
using Wg32 = Wg<32>;
using Wg64 = Wg<64>;
constexpr int WG_TD = Wg64::TD;  // the D slice (the q layout's step)

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// The queries' offset (in floats) of element (row b, column d) in the split
// layout: per block of BQ rows and D slice of TD columns, a Q_ELEMS run
// holding the slice's k8 steps one after the other; within a step, the
// core matrix of rows 8 i .. 8 i + 7 and columns 4 h .. 4 h + 3 at
// (2 i + h) * 32, its row r at 4 r. The slice's columns are permuted
// into the steps as the candidate side reads them (below).
__host__ __device__ __forceinline__ size_t q_offset(int bq, int n_steps,
                                                    int b, int d) {
  const int n = b % bq, kk = d % WG_TD;
  // the k8 step j and its column c that hold column kk of the slice: a
  // thread loads 8 neighbouring columns of a candidate row (8 t .. 8 t + 7)
  // and feeds columns 8 t + 2 j and 8 t + 2 j + 1 to step j as its
  // fragment columns t and t + 4
  const int j = (kk % 8) / 2, c = kk / 8 + 4 * (kk % 2);
  return ((size_t)(b / bq) * n_steps + d / WG_TD) * bq * WG_TD +
         j * bq * 8 + (n / 8) * 64 + (c / 4) * 32 + (n % 8) * 4 + c % 4;
}

// Split q (B, D) into its TF32 halves in the layout above, zero-padded to
// `rows` rows and n_steps * TD columns. One thread an element.
__global__ void split_q_kernel(const float* __restrict__ q, float* hi,
                               float* lo, int B, int D, int bq, int rows,
                               int n_steps) {
  const size_t cols = (size_t)n_steps * WG_TD;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= rows * cols) return;
  const int b = (int)(e / cols), d = (int)(e % cols);
  const float x = b < B && d < D ? q[(size_t)b * D + d] : 0.0f;
  const float h = tf32_round(x);
  const size_t o = q_offset(bq, n_steps, b, d);
  hi[o] = h;
  lo[o] = tf32_round(x - h);
}

// A shared-memory matrix descriptor for wgmma: K-major, no swizzle; the
// two core matrices of a k step 128 bytes apart (leading dimension), the
// groups of 8 rows 256 bytes apart (stride dimension).
constexpr uint64_t WG_LBO = 128;
constexpr uint64_t WG_SBO = 256;
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint64_t addr = static_cast<uint64_t>(__cvta_generic_to_shared(p));
  return ((addr & 0x3FFFF) >> 4) | ((WG_LBO >> 4) << 16) |
         ((WG_SBO >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps a register live and unmoved across the asynchronous wgmma
__device__ __forceinline__ void hold(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void hold(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}
// orders this thread's view of shared memory before the tensor cores' reads
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[8],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(accumulate));
}

// Stage QS D slices (from slice `first`, up to `n_steps`) of the block's
// split queries into one ring slot: their hi runs, then their lo runs
// (contiguous in both layouts), 16-byte copies.
template <class T>
__device__ __forceinline__ void wg_load(const float* __restrict__ q_hi,
                                        const float* __restrict__ q_lo,
                                        float* slot, int first, int n_steps) {
  const size_t off = (size_t)first * T::Q_ELEMS;
  const int n = (n_steps - first < T::QS ? n_steps - first : T::QS) *
                T::Q_ELEMS;
  for (int e = threadIdx.x * 4; e < n; e += T::THREADS * 4) {
    cp_async<16>(slot + e, q_hi + off + e, true);
    cp_async<16>(slot + T::QS * T::Q_ELEMS + e, q_lo + off + e, true);
  }
}

// A thread's candidate values of one D slice: rows g and g + 8 of its
// warp's 16, columns 8 t .. 8 t + 7 as 4 pairs (pair j feeds k8 step j),
// read straight from device memory (8-byte loads where D is even and C
// 8-byte aligned), zero outside the problem.
template <int VEC>
__device__ __forceinline__ void load_c(const float* __restrict__ r0,
                                       const float* __restrict__ r1,
                                       int d, int D, float2 (&cb)[2][4]) {
  const float* rows[2] = {r0, r1};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int e = d + 2 * j;
      const float* r = rows[h];
      if constexpr (VEC == 2) {
        cb[h][j] = r != nullptr && e < D
                       ? __ldg(reinterpret_cast<const float2*>(r + e))
                       : make_float2(0.0f, 0.0f);
      } else {
        cb[h][j] = make_float2(r != nullptr && e < D ? __ldg(r + e) : 0.0f,
                               r != nullptr && e + 1 < D ? __ldg(r + e + 1)
                                                         : 0.0f);
      }
    }
}

// One D slice of a tile for a thread: at the first slice of a ring slot,
// wait for its queries (and refill the slot freed by the last one); split the thread's candidate
// values `cb` into wgmma fragments (element i: row g + 8 (i & 1), the
// pair's first value for i < 2, its second for i >= 2), reload `cb` with
// the slice two ahead, and take the three products lo_C * hi_q,
// hi_C * lo_q and hi_C * hi_q per k8 step, the slice's first one
// overwriting the accumulators. Once they are done the slice's sum is
// added to `total` with a rounded f32 add: the tensor cores' own
// accumulation keeps fewer bits than that add, and over the 3816 k8 steps
// of D = 30522 its error on the dense corpus's sums of positive terms
// reached about 1e-4 of them on the H100.
template <class T, int VEC>
__device__ __forceinline__ void wg_step(const float* q_hi, const float* q_lo,
                                        float* ring, const float* r0,
                                        const float* r1, int s, int n_steps,
                                        int D, int t, float2 (&cb)[2][4],
                                        float (&acc)[T::NACC],
                                        float (&total)[T::NACC]) {
  const int u = s / T::QS;  // the ring slot's use
  if (s % T::QS == 0) {  // the first slice of a slot
    cp_async_wait<T::STAGES - 2>();
    __syncthreads();  // slot u has landed; slot u - 1 is free to refill
    const int next = u + T::STAGES - 1;
    if (next * T::QS < n_steps)
      wg_load<T>(q_hi, q_lo, ring + (next % T::STAGES) * T::STAGE,
                 next * T::QS, n_steps);
    cp_async_commit();
  }

  uint32_t ah[T::KSTEPS][4], al[T::KSTEPS][4];
#pragma unroll
  for (int j = 0; j < T::KSTEPS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p = cb[i & 1][j];
      const float x = i < 2 ? p.x : p.y;
      const float h = tf32_round(x);
      ah[j][i] = __float_as_uint(h);
      al[j][i] = __float_as_uint(tf32_round(x - h));
    }
  if (s + 2 < n_steps) load_c<VEC>(r0, r1, (s + 2) * T::TD + 8 * t, D, cb);

  const float* qh =
      ring + (u % T::STAGES) * T::STAGE + (s % T::QS) * T::Q_ELEMS;
  const float* ql = qh + T::QS * T::Q_ELEMS;
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) hold(acc[i]);
  fence_async_smem();
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < T::KSTEPS; ++j) {
    const uint64_t dh = smem_desc(qh + j * T::BQ * 8);
    const uint64_t dl = smem_desc(ql + j * T::BQ * 8);
    wgmma_tf32(acc, al[j], dh, j > 0);
    wgmma_tf32(acc, ah[j], dl, 1);
    wgmma_tf32(acc, ah[j], dh, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) hold(acc[i]);
#pragma unroll
  for (int j = 0; j < T::KSTEPS; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      hold(ah[j][i]);
      hold(al[j][i]);
    }
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) total[i] = __fadd_rn(total[i], acc[i]);
}

// Pass 1, B > 8: block (g, y) scores query rows y * BQ .. + BQ against
// candidate tiles g * tiles_per_block .. and writes its kp best per row.
// `lists` is the workspace slice for the running lists, or null when they
// sit in shared memory after the tile's ids.
template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
    wg_kernel(const float* __restrict__ q_hi, const float* __restrict__ q_lo,
              const float* __restrict__ C, float* part_v, int* part_i,
              float* lists, int B, int N, int D, int kp, int tiles_per_block,
              int n_steps) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* tile_ids = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);
  const size_t block = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
  Lists L = carve_lists(
      lists ? lists + block * 4 * T::BQ * kp
            : reinterpret_cast<float*>(tile_ids + T::BN),
      T::BQ, kp);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = 16 * warp + g;  // the thread's first candidate of a tile
  const int b0 = blockIdx.y * T::BQ;
  const int rows = min(T::BQ, B - b0);
  const size_t q_off = (size_t)blockIdx.y * n_steps * T::Q_ELEMS;
  const float* qh = q_hi + q_off;
  const float* ql = q_lo + q_off;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int t_end = min(n_tiles, (int)(blockIdx.x + 1) * tiles_per_block);
  int len = 0;

  for (int tile = blockIdx.x * tiles_per_block; tile < t_end; ++tile) {
    const int n0 = tile * T::BN;
    const float* r0 =
        n0 + row < N ? C + (size_t)(n0 + row) * D : nullptr;
    const float* r1 =
        n0 + row + 8 < N ? C + (size_t)(n0 + row + 8) * D : nullptr;
    float acc[T::NACC], total[T::NACC];
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) total[i] = 0.0f;

    for (int u = 0; u < T::STAGES - 1; ++u) {
      if (u * T::QS < n_steps)
        wg_load<T>(qh, ql, ring + u * T::STAGE, u * T::QS, n_steps);
      cp_async_commit();
    }
    float2 ca[2][4], cb[2][4];  // slices alternate between two buffers
    if (n_steps > 0) load_c<VEC>(r0, r1, 8 * t, D, ca);
    if (n_steps > 1) load_c<VEC>(r0, r1, T::TD + 8 * t, D, cb);
    for (int s = 0; s < n_steps; s += 2) {
      wg_step<T, VEC>(qh, ql, ring, r0, r1, s, n_steps, D, t, ca, acc,
                      total);
      if (s + 1 < n_steps)
        wg_step<T, VEC>(qh, ql, ring, r0, r1, s + 1, n_steps, D, t, cb, acc,
                        total);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is idle: the score tile may alias it

    float* sc = ring;  // (BQ, LDS): query rows, candidate columns
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) {
      // accumulator i: candidate row + 8 ((i / 2) & 1), query
      // 8 (i / 4) + 2 t + i % 2
      const int c = row + 8 * ((i >> 1) & 1);
      const int qr = 8 * (i >> 2) + 2 * t + (i & 1);
      sc[qr * T::LDS + c] = total[i];
    }
    const int valid = min(T::BN, N - n0);
    for (int j = tid; j < T::BN; j += T::THREADS)
      tile_ids[j] = j < valid ? n0 + j : -1;
    __syncthreads();
    merge_step(rows, T::BN, sc, T::LDS, tile_ids, L, len, kp);
    __syncthreads();
    L.swap();
    len = min(kp, len + valid);
  }
  write_partial(L, len, kp, rows, b0, part_v, part_i);
}

// ---------------------------------------------------------------------------
// Pass 1 for B <= 8: streaming f32 FMAs
// ---------------------------------------------------------------------------

// The candidate rows are read straight from device memory, each warp
// walking SR rows side by side, lane l taking the VEC-wide pieces at d =
// VEC * l + 32 * VEC * i of every row, so one load instruction reads 32 *
// VEC contiguous floats of a row, and SU such pieces of every row are
// loaded before their FMAs (fewer in flight left the memory idle). The
// queries are staged SDC columns at a time through a double buffer of
// cp.async copies. A lane sums its pieces in ascending d; a butterfly of
// shuffles then adds the 32 lanes' sums in a fixed order. Tiles of S_BN
// candidates, G ranges of tiles, the running lists and the partials are as
// in wg_kernel.
constexpr int SB = 8;                 // query rows
constexpr int SR = 4;                 // candidate rows per warp
constexpr int SWARPS = 8;
constexpr int S_THREADS = 32 * SWARPS;
constexpr int S_BN = SR * SWARPS;     // candidates per tile
constexpr int SDC = 1024;             // query columns per staged chunk
constexpr int SU = 4;                 // pieces of each row loaded at once

struct Stream {  // stream_kernel's shape, for the launch plan
  static constexpr int BM = SB, BN = S_BN;
  static size_t ring_bytes() {  // two query chunks, a score tile, its ids
    return (size_t)(2 * SB * SDC + SB * S_BN + S_BN) * sizeof(float);
  }
};

template <int VEC>
__device__ __forceinline__ void load_query_chunk(const float* __restrict__ q,
                                                 float* qs, int B, int D,
                                                 int c0) {
  constexpr int PER_ROW = SDC / VEC;
  for (int e = threadIdx.x; e < SB * PER_ROW; e += S_THREADS) {
    const int m = e / PER_ROW, d = (e % PER_ROW) * VEC;
    const bool in = m < B && c0 + d < D;
    cp_async<4 * VEC>(qs + m * SDC + d, in ? q + (size_t)m * D + c0 + d : q,
                      in);
  }
}

template <int VEC>
__global__ void __launch_bounds__(S_THREADS)
    stream_kernel(const float* __restrict__ q, const float* __restrict__ C,
                  float* part_v, int* part_i, float* lists, int B, int N,
                  int D, int kp, int tiles_per_block) {
  using Piece = typename std::conditional<VEC == 2, float2, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);   // 2 x (SB, SDC)
  float* sc = qbuf + 2 * SB * SDC;                 // (SB, S_BN)
  int* tile_ids = reinterpret_cast<int*>(sc + SB * S_BN);
  Lists L = carve_lists(
      lists ? lists + (size_t)blockIdx.x * 4 * SB * kp
            : reinterpret_cast<float*>(tile_ids + S_BN),
      SB, kp);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int rows = min(SB, B);
  const int n_tiles = (N + S_BN - 1) / S_BN;
  const int t_end = min(n_tiles, (int)(blockIdx.x + 1) * tiles_per_block);
  const int n_chunks = (D + SDC - 1) / SDC;
  int len = 0;

  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int n0 = t * S_BN + warp * SR;
    const Piece* crow[SR];
    bool live[SR];
#pragma unroll
    for (int r = 0; r < SR; ++r) {
      live[r] = n0 + r < N;
      crow[r] = reinterpret_cast<const Piece*>(
          C + (size_t)(live[r] ? n0 + r : 0) * D);
    }
    float acc[SR][SB];
#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int m = 0; m < SB; ++m) acc[r][m] = 0.0f;

    if (n_chunks > 0) load_query_chunk<VEC>(q, qbuf, B, D, 0);
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      const int c0 = c * SDC;
      if (c + 1 < n_chunks)
        load_query_chunk<VEC>(q, qbuf + ((c + 1) % 2) * SB * SDC, B, D,
                              c0 + SDC);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();  // chunk c has landed
      const float* qs = qbuf + (c % 2) * SB * SDC;
      const int dn = min(SDC, D - c0);
      constexpr int STEP = 32 * VEC;
      for (int d0 = VEC * lane; d0 < dn; d0 += SU * STEP) {
        Piece x[SU][SR];  // all loads of the batch first, then the FMAs
#pragma unroll
        for (int u = 0; u < SU; ++u)
#pragma unroll
          for (int r = 0; r < SR; ++r)
            x[u][r] = live[r] && d0 + u * STEP < dn
                          ? crow[r][(c0 + d0 + u * STEP) / VEC]
                          : Piece{};
#pragma unroll
        for (int u = 0; u < SU; ++u) {
          const int d = d0 + u * STEP;
          if (d >= dn) break;
#pragma unroll
          for (int m = 0; m < SB; ++m) {
            const Piece y =
                *reinterpret_cast<const Piece*>(qs + m * SDC + d);
#pragma unroll
            for (int r = 0; r < SR; ++r) {
              if constexpr (VEC == 2) {
                acc[r][m] = fmaf(y.x, x[u][r].x, acc[r][m]);
                acc[r][m] = fmaf(y.y, x[u][r].y, acc[r][m]);
              } else {
                acc[r][m] = fmaf(y, x[u][r], acc[r][m]);
              }
            }
          }
        }
      }
      __syncthreads();  // every warp is done with chunk c's buffer
    }

#pragma unroll
    for (int r = 0; r < SR; ++r)
#pragma unroll
      for (int m = 0; m < SB; ++m) {
        float v = acc[r][m];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        if (lane == 0) sc[m * S_BN + warp * SR + r] = v;
      }
    const int valid = min(S_BN, N - t * S_BN);
    for (int j = tid; j < S_BN; j += S_THREADS)
      tile_ids[j] = j < valid ? t * S_BN + j : -1;
    __syncthreads();
    merge_step(rows, S_BN, sc, S_BN, tile_ids, L, len, kp);
    __syncthreads();
    L.swap();
    len = min(kp, len + valid);
  }
  write_partial(L, len, kp, rows, 0, part_v, part_i);
}

// ---------------------------------------------------------------------------
// Pass 2
// ---------------------------------------------------------------------------

// Block b merges the `entries` partial entries of query row b, CHUNK at a
// time, and writes its k best, padded with (NEG_INF, 0). `lists` is the
// workspace slice for the running lists, or null when they fit in shared
// memory.
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ part_v,
                 const int* __restrict__ part_i, float* lists,
                 float* __restrict__ vals, int* __restrict__ idx, int entries,
                 int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* chunk_v = reinterpret_cast<float*>(smem);
  int* chunk_i = reinterpret_cast<int*>(chunk_v + CHUNK);
  Lists L = carve_lists(
      lists ? lists + (size_t)blockIdx.x * 4 * k
            : reinterpret_cast<float*>(chunk_i + CHUNK),
      1, k);

  const size_t base = (size_t)blockIdx.x * entries;
  int len = 0;
  for (int c0 = 0; c0 < entries; c0 += CHUNK) {
    const int e = c0 + threadIdx.x;
    const int id = e < entries ? part_i[base + e] : -1;
    chunk_v[threadIdx.x] = id >= 0 ? part_v[base + e] : NEG_INF;
    chunk_i[threadIdx.x] = id;
    const int valid = __syncthreads_count(id >= 0);
    merge_step(1, CHUNK, chunk_v, CHUNK, chunk_i, L, len, k);
    __syncthreads();
    L.swap();
    len = min(k, len + valid);
  }
  for (int p = threadIdx.x; p < k; p += MERGE_THREADS) {
    vals[(size_t)blockIdx.x * k + p] = p < len ? L.rv[p] : NEG_INF;
    idx[(size_t)blockIdx.x * k + p] = p < len ? L.ri[p] : 0;
  }
}

// ---------------------------------------------------------------------------
// The launch plan and the workspace
// ---------------------------------------------------------------------------

struct Plan {
  int bm;               // 8 (stream_kernel), 16, 32 or 64 (wg_kernel)
  int gy;               // blocks along the queries
  int G;                // candidate ranges (blocks along N)
  int tiles_per_block;
  int kp;               // entries a block keeps per query row
  int n_steps;          // D slices of the split queries (wg_kernel)
  size_t smem;          // pass 1's dynamic shared memory
  bool lists_ws;        // pass 1's running lists in the workspace
  size_t merge_smem;
  bool merge_ws;        // pass 2's running lists in the workspace
  // workspace layout, in bytes: the split queries (both halves), partial
  // values and ids, pass 1's and pass 2's lists
  size_t off_q, off_pv, off_pi, off_l1, off_l2, bytes;
};

size_t align_up(size_t x) { return (x + WS_ALIGN - 1) / WS_ALIGN * WS_ALIGN; }

// G ranges of whole tiles of T, for as many blocks as fit on the SMs.
template <class T>
void plan_ranges(int B, int N, int k, int sms, int per_sm, Plan* p) {
  p->bm = T::BM;
  p->gy = (B + T::BM - 1) / T::BM;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int want = (per_sm * sms + p->gy - 1) / p->gy;
  const int G = n_tiles < want ? n_tiles : want;
  p->tiles_per_block = G > 0 ? (n_tiles + G - 1) / G : 0;
  p->G = G > 0 ? (n_tiles + p->tiles_per_block - 1) / p->tiles_per_block : 0;
  const long long range = (long long)p->tiles_per_block * T::BN;
  p->kp = (int)(k < range ? k : range);
  const size_t lists = (size_t)4 * T::BM * p->kp * sizeof(float);
  p->lists_ws = T::ring_bytes() + lists > SMEM_MAX;
  p->smem = T::ring_bytes() + (p->lists_ws ? 0 : lists);
}

template <class T>
int wg_per_sm(int k) {  // blocks of T an SM holds at small k
  const size_t lists = (size_t)4 * T::BM * (k < T::BN ? k : T::BN) * 4;
  const size_t per = T::ring_bytes() + lists + 1024;
  return per < SMEM_SM / 2 ? (int)(SMEM_SM / per) : 1;
}

cudaError_t make_plan(int B, int N, int D, int k, Plan* p) {
  if (B < 1 || N < 0 || D < 0 || k < 1) return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  p->n_steps = 0;
  if (B <= SB) {
    plan_ranges<Stream>(B, N, k, sms, 2, p);
  } else {
    if (B <= 16)
      plan_ranges<Wg16>(B, N, k, sms, wg_per_sm<Wg16>(k), p);
    else if (B <= 32)
      plan_ranges<Wg32>(B, N, k, sms, wg_per_sm<Wg32>(k), p);
    else
      plan_ranges<Wg64>(B, N, k, sms, wg_per_sm<Wg64>(k), p);
    p->n_steps = (D + WG_TD - 1) / WG_TD;
  }
  const size_t merge_lists = (size_t)4 * k * sizeof(float);
  p->merge_smem = (size_t)2 * CHUNK * sizeof(float);
  p->merge_ws = p->merge_smem + merge_lists > SMEM_MAX;
  if (!p->merge_ws) p->merge_smem += merge_lists;

  const size_t partial = (size_t)B * p->G * p->kp * sizeof(float);
  p->off_q = 0;
  p->off_pv = align_up((size_t)2 * p->gy * p->bm * p->n_steps * WG_TD *
                       sizeof(float));
  p->off_pi = p->off_pv + align_up(partial);
  p->off_l1 = p->off_pi + align_up(partial);
  p->off_l2 = p->off_l1 + (p->lists_ws ? align_up((size_t)p->G * p->gy * 4 *
                                                  p->bm * p->kp * 4)
                                       : 0);
  p->bytes = p->off_l2 + (p->merge_ws ? (size_t)B * 4 * k * 4 : 0);
  return cudaSuccess;
}

// The queries split once per call, then pass 1 on the tensor cores.
template <class T, int VEC>
cudaError_t launch_wg(const Plan& p, const float* q, const float* C,
                      unsigned char* ws, int B, int N, int D,
                      cudaStream_t stream) {
  float* q_hi = reinterpret_cast<float*>(ws + p.off_q);
  const size_t half = (size_t)p.gy * T::BQ * p.n_steps * WG_TD;
  float* q_lo = q_hi + half;
  if (half > 0) {
    const int threads = 256;
    split_q_kernel<<<(unsigned)((half + threads - 1) / threads), threads, 0,
                     stream>>>(q, q_hi, q_lo, B, D, T::BQ, p.gy * T::BQ,
                               p.n_steps);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  auto* kernel = &wg_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.G, p.gy), T::THREADS, p.smem, stream>>>(
      q_hi, q_lo, C, reinterpret_cast<float*>(ws + p.off_pv),
      reinterpret_cast<int*>(ws + p.off_pi),
      p.lists_ws ? reinterpret_cast<float*>(ws + p.off_l1) : nullptr, B, N, D,
      p.kp, p.tiles_per_block, p.n_steps);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_score(const Plan& p, const float* q, const float* C,
                         unsigned char* ws, int B, int N, int D,
                         cudaStream_t stream) {
  if (p.bm == SB) {
    auto* kernel = &stream_kernel<VEC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.G, S_THREADS, p.smem, stream>>>(
        q, C, reinterpret_cast<float*>(ws + p.off_pv),
        reinterpret_cast<int*>(ws + p.off_pi),
        p.lists_ws ? reinterpret_cast<float*>(ws + p.off_l1) : nullptr, B, N,
        D, p.kp, p.tiles_per_block);
    return cudaGetLastError();
  }
  if (p.bm == 16) return launch_wg<Wg16, VEC>(p, q, C, ws, B, N, D, stream);
  if (p.bm == 32) return launch_wg<Wg32, VEC>(p, q, C, ws, B, N, D, stream);
  return launch_wg<Wg64, VEC>(p, q, C, ws, B, N, D, stream);
}

}  // namespace

// The workspace topk_score needs for this problem on the current device,
// in bytes, or -1 for arguments it does not take (B >= 1, N >= 0, D >= 0,
// k >= 1).
// The largest batch that stream_kernel (f32 FMAs) takes; larger ones take
// wg_kernel (3xTF32).
extern "C" int topk_score_stream_rows() { return SB; }

extern "C" long long topk_score_workspace(int B, int N, int D, int k) {
  Plan p;
  return make_plan(B, N, D, k, &p) == cudaSuccess ? (long long)p.bytes : -1;
}

// C entry point, bound with ctypes. q (B, D) and C (N, D) f32 row-major; ws
// a device buffer of ws_bytes >= topk_score_workspace(B, N, D, k), 256-byte
// aligned; vals f32 and idx i32 are (B, k). Returns the first CUDA error of
// the launches (cudaErrorInvalidValue for arguments it does not take).
extern "C" int topk_score(const float* q, const float* C, void* ws,
                          long long ws_bytes, float* vals, int* idx, int B,
                          int N, int D, int k, void* stream_ptr) {
  Plan p;
  cudaError_t err = make_plan(B, N, D, k, &p);
  if (err != cudaSuccess) return (int)err;
  if (ws_bytes < 0 || (size_t)ws_bytes < p.bytes ||
      reinterpret_cast<uintptr_t>(ws) % WS_ALIGN != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  unsigned char* w = static_cast<unsigned char*>(ws);
  if (p.G > 0) {
    const bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(C) % 8 == 0;
    err = pairs ? launch_score<2>(p, q, C, w, B, N, D, stream)
                : launch_score<1>(p, q, C, w, B, N, D, stream);
    if (err != cudaSuccess) return (int)err;
  }
  if (p.merge_smem > 48 * 1024) {
    err = cudaFuncSetAttribute(merge_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)p.merge_smem);
    if (err != cudaSuccess) return (int)err;
  }
  merge_kernel<<<B, MERGE_THREADS, p.merge_smem, stream>>>(
      reinterpret_cast<const float*>(w + p.off_pv),
      reinterpret_cast<const int*>(w + p.off_pi),
      p.merge_ws ? reinterpret_cast<float*>(w + p.off_l2) : nullptr, vals, idx,
      p.G * p.kp, k);
  return (int)cudaGetLastError();
}
