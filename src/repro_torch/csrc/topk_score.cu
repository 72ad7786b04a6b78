// Dense scoring with a streaming top-k for Hopper (sm_90a): K6.
//
// Replaces the Pallas TPU kernel src/repro/kernels/topk_score.py:_topk_kernel
// (entry topk_score). For queries q (B, D) and candidates C (N, D), both f32
// and row-major, it returns per query row the k best of
//
//     score[b, n] = sum over d of q[b, d] * C[n, d]   (f32 FMAs, d ascending)
//
// ordered by value descending, then candidate id ascending, without writing
// the (B, N) score matrix to device memory. When k > N the columns past N
// hold (NEG_INF, 0), as in the reference.
//
// Design. The Pallas grid walks the candidates in order on one core, with
// the running top-k carried in the output block; translated block for
// block it would stream the whole corpus through one SM at the serving
// batch. Here the candidates are cut into tiles and the tiles into G
// contiguous ranges, G chosen so that about two blocks run per SM. Pass 1
// gives each block one range and a group of query rows, forms each tile's
// scores, and merges them into a running top-k per query row in shared
// memory; at the end it writes its k best per row to a partial buffer.
// Pass 2 (merge_kernel) merges the G partial lists of each query row.
//
// Pass 1 has two forms. Small batches (B <= 8, the serving path) take
// stream_kernel: each warp reads 4 candidate rows straight from device
// memory, 64 contiguous floats of a row per load, with 4 such loads of
// every row issued before their FMAs so that enough bytes are in flight;
// the queries are staged through shared memory. Larger batches take
// score_kernel: a SIMT GEMM whose D slices are staged through a ring of
// cp.async copies (queries transposed, candidate rows as they lie), each
// thread keeping a register tile of sums, so that one pass over the corpus
// serves 32 or 64 queries. Both read C in place: a row of 30522 floats is
// 8-byte but not 16-byte aligned, so loads are 8 bytes wide for an even D
// and 4 for an odd one.
//
// Determinism. Each score is one thread's chain of FMAs over its d in
// ascending order (stream_kernel then adds the 32 lanes' chains in a fixed
// butterfly), the same for every candidate and every launch. A merge places
// each entry at its rank under the strict order (value desc, id asc) among
// the union of the running list and the new entries, so the result is the
// k best of a set, whatever the order of the tiles, ranges or chunks: two
// launches give the same bits, and no atomics are used.
//
// Bound on the H100: the kernel must read C once (N * D * 4 bytes) and do
// 2 * B * N * D FLOP. At the serving shape (B = 8, N = 16384, D = 30522)
// that is 2.0 GB against 8 GFLOP: bytes bound it, 0.60 ms at 3.35 TB/s;
// stream_kernel reaches about two thirds of that rate (a plain read of the
// same bytes, torch.sum, about 90 %). At B = 64 the FLOP bound it, 0.96 ms
// at 67 TFLOP/s f32, and score_kernel runs at about a third of that peak.
// Tensor cores would round to TF32 and move ids; wgmma on split-f32
// operands, TMA bulk copies of the rows and a persistent grid are the
// later steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int MAX_K = 256;         // the wrapper's limit too
constexpr int CHUNK = 256;         // partial entries merged per step (pass 2)
constexpr int MERGE_THREADS = CHUNK;
constexpr size_t SMEM_MAX = 232448;  // dynamic shared memory a block may use
constexpr float NEG_INF = -1e30f;

// The strict order of the result: value descending, then id ascending.
__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// A block scores BM query rows against tiles of BN candidates, staging D
// slices of TD through a ring of STAGES slots. TY x TX threads, each with
// TM query rows (ty * TM + i) and TN candidates (tx + TX * j).
template <int BM_, int TM_, int TY_, int TX_, int BN_, int TD_, int STAGES_>
struct Tile {
  static constexpr int BM = BM_, TM = TM_, TY = TY_, TX = TX_;
  static constexpr int BN = BN_, TD = TD_, STAGES = STAGES_;
  static constexpr int THREADS = TY * TX;
  static constexpr int TN = BN / TX;
  static constexpr int LDQ = BM + 4;      // staged queries: (TD, LDQ)
  static constexpr int LDC = TD + 2;      // staged candidates: (BN, LDC)
  static constexpr int Q_ELEMS = TD * LDQ;
  static constexpr int STAGE = Q_ELEMS + BN * LDC;   // floats per ring slot
  static_assert(BM == TM * TY && BN == TN * TX, "tile shape");
  static_assert(TM % 4 == 0, "query values are read four at a time");
  static_assert(TD % 2 == 0 && STAGES >= 2, "pairs of d; a ring");
  static_assert(STAGE % 4 == 0 && Q_ELEMS % 4 == 0, "16-byte slots");
  static_assert(BM * BN <= STAGES * STAGE, "the score tile aliases the ring");

  static size_t smem(int k) {  // ring, tile ids, two running lists
    return (size_t)(STAGES * STAGE + BN) * sizeof(float) +
           (size_t)4 * BM * k * sizeof(float);
  }
};
using Tile32 = Tile<32, 4, 8, 32, 128, 32, 4>;    // 256 threads, 4 x 4 sums
using Tile64 = Tile<64, 8, 8, 32, 128, 32, 3>;    // 256 threads, 8 x 4 sums

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

// Stage the D slice [d0, d0 + TD) of the block's query rows (transposed,
// qs[d * LDQ + m]) and of candidate rows n0 .. n0 + BN (cs[r * LDC + d])
// into one ring slot. Elements outside the problem are zero-filled.
template <class T, int VEC>
__device__ __forceinline__ void load_stage(const float* __restrict__ q,
                                           const float* __restrict__ C,
                                           float* slot, int B, int N, int D,
                                           int b0, int n0, int d0) {
  float* qs = slot;
  float* cs = slot + T::Q_ELEMS;
  for (int e = threadIdx.x; e < T::BM * T::TD; e += T::THREADS) {
    const int m = e / T::TD, d = e % T::TD;
    const bool in = b0 + m < B && d0 + d < D;
    cp_async<4>(qs + d * T::LDQ + m,
                in ? q + (size_t)(b0 + m) * D + d0 + d : q, in);
  }
  constexpr int PER_ROW = T::TD / VEC;
  for (int e = threadIdx.x; e < T::BN * PER_ROW; e += T::THREADS) {
    const int r = e / PER_ROW, d = (e % PER_ROW) * VEC;
    // with VEC == 2, D is even, so d0 + d < D covers both elements
    const bool in = n0 + r < N && d0 + d < D;
    cp_async<4 * VEC>(cs + r * T::LDC + d,
                      in ? C + (size_t)(n0 + r) * D + d0 + d : C, in);
  }
}

// One ring slot's TD-deep contribution to the thread's TM x TN sums, d
// ascending within the slot.
template <class T>
__device__ __forceinline__ void compute_stage(const float* slot,
                                              float (&acc)[T::TM][T::TN],
                                              int ty, int tx) {
  const float* qs = slot + ty * T::TM;
  const float* cs = slot + T::Q_ELEMS + tx * T::LDC;
#pragma unroll
  for (int d = 0; d < T::TD; d += 2) {
    float a0[T::TM], a1[T::TM];
#pragma unroll
    for (int i = 0; i < T::TM; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(qs + d * T::LDQ + i);
      const float4 y =
          *reinterpret_cast<const float4*>(qs + (d + 1) * T::LDQ + i);
      a0[i] = x.x, a0[i + 1] = x.y, a0[i + 2] = x.z, a0[i + 3] = x.w;
      a1[i] = y.x, a1[i + 1] = y.y, a1[i + 2] = y.z, a1[i + 3] = y.w;
    }
#pragma unroll
    for (int j = 0; j < T::TN; ++j) {
      const float2 c =
          *reinterpret_cast<const float2*>(cs + j * T::TX * T::LDC + d);
#pragma unroll
      for (int i = 0; i < T::TM; ++i) {
        acc[i][j] = fmaf(a0[i], c.x, acc[i][j]);
        acc[i][j] = fmaf(a1[i], c.y, acc[i][j]);
      }
    }
  }
}

// One merge step for `rows` rows, block-wide. Row r's running list (rv, ri
// at r * k: `len` entries, best first) takes in the row's new entries
// (tv[r * ldt + j], ids[j]) for j < cols, an id < 0 marking an empty
// entry; the best k of the union go, best first, to (nv, ni). Each entry
// lands at its rank in the union: the running entries better than it
// (a binary search) plus the new entries better than it (a count). A new
// entry that cannot beat a full list's last entry is skipped.
__device__ __forceinline__ void merge_step(int rows, int cols, const float* tv, int ldt,
                           const int* ids, const float* rv, const int* ri,
                           float* nv, int* ni, int len, int k) {
  for (int p = threadIdx.x; p < rows * cols; p += blockDim.x) {
    const int r = p / cols, j = p % cols;
    const int xi = ids[j];
    if (xi < 0) continue;
    const float x = tv[r * ldt + j];
    const float* rrv = rv + r * k;
    const int* rri = ri + r * k;
    if (len == k && !better(x, xi, rrv[k - 1], rri[k - 1])) continue;
    int lo = 0, hi = len;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (better(rrv[mid], rri[mid], x, xi))
        lo = mid + 1;
      else
        hi = mid;
    }
    int pos = lo;
    for (int jj = 0; jj < cols && pos < k; ++jj) {
      const int yi = ids[jj];
      pos += yi >= 0 && better(tv[r * ldt + jj], yi, x, xi);
    }
    if (pos < k) {
      nv[r * k + pos] = x;
      ni[r * k + pos] = xi;
    }
  }
  for (int p = threadIdx.x; p < rows * len; p += blockDim.x) {
    const int r = p / len, at = p % len;
    const float z = rv[r * k + at];
    const int zi = ri[r * k + at];
    int pos = at;
    for (int jj = 0; jj < cols && pos < k; ++jj) {
      const int yi = ids[jj];
      pos += yi >= 0 && better(tv[r * ldt + jj], yi, z, zi);
    }
    if (pos < k) {
      nv[r * k + pos] = z;
      ni[r * k + pos] = zi;
    }
  }
}

// Pass 1: block (g, y) scores query rows y * BM .. + BM against candidate
// tiles g * tiles_per_block .. and writes its k best per row to
// part[(b * G + g) * k + .], padded with (NEG_INF, -1).
template <class T, int VEC>
__global__ void __launch_bounds__(T::THREADS)
    score_kernel(const float* __restrict__ q, const float* __restrict__ C,
                 float* __restrict__ part_v, int* __restrict__ part_i, int B,
                 int N, int D, int k, int tiles_per_block) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  int* tile_ids = reinterpret_cast<int*>(ring + T::STAGES * T::STAGE);
  float* run_v = reinterpret_cast<float*>(tile_ids + T::BN);
  int* run_i = reinterpret_cast<int*>(run_v + T::BM * k);
  float* new_v = reinterpret_cast<float*>(run_i + T::BM * k);
  int* new_i = reinterpret_cast<int*>(new_v + T::BM * k);

  const int tid = threadIdx.x;
  const int ty = tid / T::TX, tx = tid % T::TX;
  const int b0 = blockIdx.y * T::BM;
  const int rows = min(T::BM, B - b0);
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int t_end = min(n_tiles, (int)(blockIdx.x + 1) * tiles_per_block);
  const int n_steps = (D + T::TD - 1) / T::TD;
  int len = 0;

  for (int t = blockIdx.x * tiles_per_block; t < t_end; ++t) {
    const int n0 = t * T::BN;
    float acc[T::TM][T::TN];
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j) acc[i][j] = 0.0f;

    for (int s = 0; s < T::STAGES - 1; ++s) {
      if (s < n_steps)
        load_stage<T, VEC>(q, C, ring + s * T::STAGE, B, N, D, b0, n0,
                           s * T::TD);
      cp_async_commit();
    }
    for (int s = 0; s < n_steps; ++s) {
      cp_async_wait<T::STAGES - 2>();
      __syncthreads();  // slot s has landed; slot s - 1 is free to refill
      const int next = s + T::STAGES - 1;
      if (next < n_steps)
        load_stage<T, VEC>(q, C, ring + (next % T::STAGES) * T::STAGE, B, N, D,
                           b0, n0, next * T::TD);
      cp_async_commit();
      compute_stage<T>(ring + (s % T::STAGES) * T::STAGE, acc, ty, tx);
    }
    cp_async_wait<0>();
    __syncthreads();  // the ring is idle: the score tile may alias it

    float* sc = ring;  // (BM, BN)
#pragma unroll
    for (int i = 0; i < T::TM; ++i)
#pragma unroll
      for (int j = 0; j < T::TN; ++j)
        sc[(ty * T::TM + i) * T::BN + tx + j * T::TX] = acc[i][j];
    const int valid = min(T::BN, N - n0);
    for (int j = tid; j < T::BN; j += T::THREADS)
      tile_ids[j] = j < valid ? n0 + j : -1;
    __syncthreads();
    merge_step(rows, T::BN, sc, T::BN, tile_ids, run_v, run_i, new_v, new_i, len,
               k);
    __syncthreads();
    float* fv = run_v;
    run_v = new_v;
    new_v = fv;
    int* fi = run_i;
    run_i = new_i;
    new_i = fi;
    len = min(k, len + valid);
  }

  for (int e = tid; e < rows * k; e += T::THREADS) {
    const int r = e / k, p = e % k;
    const size_t o = ((size_t)(b0 + r) * gridDim.x + blockIdx.x) * k + p;
    part_v[o] = p < len ? run_v[r * k + p] : NEG_INF;
    part_i[o] = p < len ? run_i[r * k + p] : -1;
  }
}

// Pass 1 for small batches (B <= SB): the candidate rows are read straight
// from device memory, each warp walking SR rows side by side, lane l taking
// the VEC-wide pieces at d = VEC * l + 32 * VEC * i of every row, so one
// load instruction reads 32 * VEC contiguous floats of a row, and SU such
// pieces of every row are loaded before their FMAs (fewer in flight left
// the memory idle). The queries are staged SDC columns at a time through a
// double buffer of cp.async copies. A lane sums its pieces in ascending d; a butterfly of shuffles
// then adds the 32 lanes' sums in a fixed order. Tiles of S_BN candidates,
// G ranges of tiles, the running lists and the partials are as in
// score_kernel.
constexpr int SB = 8;                 // query rows
constexpr int SR = 4;                 // candidate rows per warp
constexpr int SWARPS = 8;
constexpr int S_THREADS = 32 * SWARPS;
constexpr int S_BN = SR * SWARPS;     // candidates per tile
constexpr int SDC = 1024;             // query columns per staged chunk
constexpr int SU = 4;                 // pieces of each row loaded at once

struct Stream {  // stream_kernel's shape, for the launch plan
  static constexpr int BM = SB, BN = S_BN;
  static size_t smem(int k) {  // two query chunks, a score tile, its ids,
    return (size_t)(2 * SB * SDC + SB * S_BN + S_BN) * sizeof(float) +
           (size_t)4 * SB * k * sizeof(float);  // two running lists
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
                  float* __restrict__ part_v, int* __restrict__ part_i, int B,
                  int N, int D, int k, int tiles_per_block) {
  using Piece = typename std::conditional<VEC == 2, float2, float>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qbuf = reinterpret_cast<float*>(smem);   // 2 x (SB, SDC)
  float* sc = qbuf + 2 * SB * SDC;                 // (SB, S_BN)
  int* tile_ids = reinterpret_cast<int*>(sc + SB * S_BN);
  float* run_v = reinterpret_cast<float*>(tile_ids + S_BN);
  int* run_i = reinterpret_cast<int*>(run_v + SB * k);
  float* new_v = reinterpret_cast<float*>(run_i + SB * k);
  int* new_i = reinterpret_cast<int*>(new_v + SB * k);

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
    merge_step(rows, S_BN, sc, S_BN, tile_ids, run_v, run_i, new_v, new_i,
               len, k);
    __syncthreads();
    float* fv = run_v;
    run_v = new_v;
    new_v = fv;
    int* fi = run_i;
    run_i = new_i;
    new_i = fi;
    len = min(k, len + valid);
  }

  for (int e = tid; e < rows * k; e += S_THREADS) {
    const int r = e / k, p = e % k;
    const size_t o = ((size_t)r * gridDim.x + blockIdx.x) * k + p;
    part_v[o] = p < len ? run_v[r * k + p] : NEG_INF;
    part_i[o] = p < len ? run_i[r * k + p] : -1;
  }
}

// Pass 2: block b merges the `entries` = G * k partial entries of query row
// b, CHUNK at a time, and writes its k best, padded with (NEG_INF, 0).
__global__ void __launch_bounds__(MERGE_THREADS)
    merge_kernel(const float* __restrict__ part_v,
                 const int* __restrict__ part_i, float* __restrict__ vals,
                 int* __restrict__ idx, int entries, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* chunk_v = reinterpret_cast<float*>(smem);
  int* chunk_i = reinterpret_cast<int*>(chunk_v + CHUNK);
  float* run_v = reinterpret_cast<float*>(chunk_i + CHUNK);
  int* run_i = reinterpret_cast<int*>(run_v + k);
  float* new_v = reinterpret_cast<float*>(run_i + k);
  int* new_i = reinterpret_cast<int*>(new_v + k);

  const size_t base = (size_t)blockIdx.x * entries;
  int len = 0;
  for (int c0 = 0; c0 < entries; c0 += CHUNK) {
    const int e = c0 + threadIdx.x;
    const int id = e < entries ? part_i[base + e] : -1;
    chunk_v[threadIdx.x] = id >= 0 ? part_v[base + e] : NEG_INF;
    chunk_i[threadIdx.x] = id;
    const int valid = __syncthreads_count(id >= 0);
    merge_step(1, CHUNK, chunk_v, CHUNK, chunk_i, run_v, run_i, new_v, new_i,
               len, k);
    __syncthreads();
    float* fv = run_v;
    run_v = new_v;
    new_v = fv;
    int* fi = run_i;
    run_i = new_i;
    new_i = fi;
    len = min(k, len + valid);
  }
  for (int p = threadIdx.x; p < k; p += MERGE_THREADS) {
    vals[(size_t)blockIdx.x * k + p] = p < len ? run_v[p] : NEG_INF;
    idx[(size_t)blockIdx.x * k + p] = p < len ? run_i[p] : 0;
  }
}

struct Plan {
  int bm;               // 8 (stream_kernel), 32 or 64 query rows a block
  int gy;               // blocks along the queries
  int G;                // candidate ranges (blocks along N)
  int tiles_per_block;
  size_t smem;
};

// G ranges of whole tiles of T, for about two blocks per SM.
template <class T>
void plan_ranges(int B, int N, int k, int sms, Plan* p) {
  p->bm = T::BM;
  p->smem = T::smem(k);
  p->gy = (B + T::BM - 1) / T::BM;
  const int n_tiles = (N + T::BN - 1) / T::BN;
  const int want = (2 * sms + p->gy - 1) / p->gy;
  const int G = n_tiles < want ? n_tiles : want;
  p->tiles_per_block = G > 0 ? (n_tiles + G - 1) / G : 0;
  p->G = G > 0 ? (n_tiles + p->tiles_per_block - 1) / p->tiles_per_block : 0;
}

// The widest tile the batch wants whose running lists fit in shared memory.
cudaError_t make_plan(int B, int N, int k, Plan* p) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (B <= SB)
    plan_ranges<Stream>(B, N, k, sms, p);
  else if (B > 32 && Tile64::smem(k) <= SMEM_MAX)
    plan_ranges<Tile64>(B, N, k, sms, p);
  else
    plan_ranges<Tile32>(B, N, k, sms, p);
  return p->smem <= SMEM_MAX ? cudaSuccess : cudaErrorInvalidValue;
}

template <class T, int VEC>
cudaError_t launch_tile(const Plan& p, const float* q, const float* C,
                        float* part_v, int* part_i, int B, int N, int D,
                        int k, cudaStream_t stream) {
  auto* kernel = &score_kernel<T, VEC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(p.G, p.gy), T::THREADS, p.smem, stream>>>(
      q, C, part_v, part_i, B, N, D, k, p.tiles_per_block);
  return cudaGetLastError();
}

template <int VEC>
cudaError_t launch_score(const Plan& p, const float* q, const float* C,
                         float* part_v, int* part_i, int B, int N, int D,
                         int k, cudaStream_t stream) {
  if (p.bm == SB) {
    auto* kernel = &stream_kernel<VEC>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return err;
    kernel<<<p.G, S_THREADS, p.smem, stream>>>(q, C, part_v, part_i, B, N, D,
                                               k, p.tiles_per_block);
    return cudaGetLastError();
  }
  if (p.bm == 64)
    return launch_tile<Tile64, VEC>(p, q, C, part_v, part_i, B, N, D, k,
                                    stream);
  return launch_tile<Tile32, VEC>(p, q, C, part_v, part_i, B, N, D, k,
                                  stream);
}

}  // namespace

// The number G of candidate ranges (pass 1's blocks along N) for this
// problem on the current device: the wrapper sizes the (B, G, k) partial
// buffers with it. Returns -1 for arguments the kernel does not take.
extern "C" int topk_score_ranges(int B, int N, int k) {
  Plan p;
  if (B < 1 || N < 0 || k < 1 || k > MAX_K) return -1;
  return make_plan(B, N, k, &p) == cudaSuccess ? p.G : -1;
}

// C entry point, bound with ctypes. q (B, D) and C (N, D) f32 row-major;
// part_v f32 and part_i i32 are (B, G, k) scratch with G from
// topk_score_ranges; vals f32 and idx i32 are (B, k). Requires B >= 1,
// N >= 0, D >= 0 and 1 <= k <= MAX_K. Returns the first CUDA error of the
// launches (cudaErrorInvalidValue for arguments it does not take).
extern "C" int topk_score(const float* q, const float* C, float* part_v,
                          int* part_i, float* vals, int* idx, int B, int N,
                          int D, int k, int G, void* stream_ptr) {
  if (B < 1 || N < 0 || D < 0 || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  Plan p;
  cudaError_t err = make_plan(B, N, k, &p);
  if (err != cudaSuccess) return (int)err;
  if (p.G != G) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (G > 0) {
    const bool pairs = D % 2 == 0 && reinterpret_cast<uintptr_t>(q) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(C) % 8 == 0;
    err = pairs ? launch_score<2>(p, q, C, part_v, part_i, B, N, D, k, stream)
                : launch_score<1>(p, q, C, part_v, part_i, B, N, D, k, stream);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t smem = (size_t)(2 * CHUNK + 4 * k) * sizeof(float);
  merge_kernel<<<B, MERGE_THREADS, smem, stream>>>(part_v, part_i, vals, idx,
                                                   G * k, k);
  return (int)cudaGetLastError();
}
