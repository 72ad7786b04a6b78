// Fused impact scoring with a streaming top-k for Hopper (sm_90a): K4 and
// K5, two entry points over one shared-memory tile and one top-k merge.
//
// K4 replaces the Pallas TPU kernel src/repro/kernels/impact_score.py:
// _impact_kernel (entry fused_impact_topk). Per query row q it computes
//
//     score[d] = sum over lanes l with docs[q, l] == d of w[q, l]
//
// K5 replaces _impact_q_kernel (entry fused_quantized_topk) in the same
// file: the lanes are u4+delta windows of a quantized index, decoded in the
// kernel. For query row q, term t and lane l < min(lens[q, t], L), and only
// where qv[q, t] > 0:
//
//     code = (starts[q, t] + l) odd ? byte_win[q, t, l] >> 4
//                                   : byte_win[q, t, l] & 0xF
//     doc  = gap_win[q, t, 0] + ... + gap_win[q, t, l]
//     w    = (lo[q, t] + (code - 1) * step[q, t]) * qv[q, t]   (code > 0)
//
// Code 0 is an escape phantom: it weighs exactly 0, but its gap still
// advances the running sum. The nibble parity comes from the absolute
// posting position, not from the lane. The products and the sum are
// rounded separately (__fmul_rn, __fadd_rn), never contracted into an FMA,
// so a weight is bit for bit the plain PyTorch version's.
//
// Both return the k best docs of each row (value descending, doc id
// ascending) without writing the (B, n_docs) score matrix to device
// memory. When k > n_docs the tail holds (NEG_INF, 0), as in the reference.
//
// Design. One block per query row. It walks the doc range in tiles of up
// to TILE_MAX docs (one tile at the serving shape); a tile's scores live
// in shared memory. The lanes are scattered into the tile one query term
// at a time (K4: one segment of seg_len lanes), with a barrier between
// terms. A doc occurs at most once in a term's posting list, so within a
// term no two lanes add a non-zero weight to the same doc (K5's phantoms
// may share a doc with the posting that follows them, but weigh 0 and are
// skipped, as K4 skips zero lanes; adding +0.0 would not change the sum):
// the shared-memory atomicAdd never contends, and each doc's sum is taken
// in term order, bit for bit the plain version's. K5 decodes each term in
// chunks of THREADS lanes: a block-wide prefix sum of the gaps (warp
// shuffles, then one warp over the warp totals) plus the carry of the
// earlier chunks gives every lane its doc id. When n_docs > TILE_MAX the
// decode runs again for each tile.
//
// The tile is then merged into a running top-k of k entries: k rounds of a
// block-wide arg-best over the union of the running entries and the tile,
// each round taking the best remaining (value, id) and marking it taken.
// Only the thread that owned the winner rescans its elements. The two
// k-entry lists sit in shared memory beside the tile while they fit (k up
// to about 6000 beside a full tile of 32768 docs); for a larger k they sit in a slice of
// a device-memory workspace that only the query's block touches, so any k
// is taken and the tile keeps its size.
//
// Bound on the H100: each lane is read once (8 bytes: K4's f32 weight and
// i32 doc id, K5's i32 packed byte and i32 gap) plus K5's five per-term
// values, and (B, k) results are written, so the floor is
// fused_window_bytes over 3.35 TB/s. At the serving shape only B blocks
// run, one per query, far from filling the 132 SMs: splitting a query's
// doc range across blocks is the next step, and for K5 reading the packed
// index in place (1.5-2.5 bytes a posting instead of 8).

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int TILE_MAX = 32768;  // docs scored per pass: 128 KB of f32
// dynamic shared memory a block may use, beside K5's static 128 bytes
constexpr size_t SMEM_MAX = 232448 - 1024;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Warp-wide arg-best of (value, id, owner slot); lane 0 ends with it.
__device__ __forceinline__ void warp_best(float& v, int& id, int& u) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(FULL, v, off);
    const int oi = __shfl_down_sync(FULL, id, off);
    const int ou = __shfl_down_sync(FULL, u, off);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
      u = ou;
    }
  }
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

// The dynamic shared memory of both kernels.
struct Tile {
  float* scores;   // (tile,) the current doc tile's scores
  float* run_val;  // (k,) running top-k
  int* run_id;
  float* new_val;  // (k,) the next running top-k
  int* new_id;
  float* warp_val;  // (WARPS,) per-warp arg-best
  int* warp_id;
  int* warp_u;
  int* winner;
};

inline size_t lists_bytes(int k) { return (size_t)k * 4 * sizeof(float); }

// the tile's scores and the arg-best scratch
inline size_t tile_bytes(int tile) {
  return (size_t)tile * sizeof(float) + (size_t)WARPS * 3 * sizeof(int) +
         sizeof(int);
}

// The shared memory of a block, and its lists: in shared memory after the
// arg-best scratch when `lists` is null, else at lists + block * 4 * k.
__device__ inline Tile carve(unsigned char* smem, int tile, int k,
                             float* lists) {
  Tile s;
  s.scores = reinterpret_cast<float*>(smem);
  s.warp_val = s.scores + tile;
  s.warp_id = reinterpret_cast<int*>(s.warp_val + WARPS);
  s.warp_u = s.warp_id + WARPS;
  s.winner = s.warp_u + WARPS;
  s.run_val = lists ? lists + (size_t)blockIdx.x * 4 * k
                    : reinterpret_cast<float*>(s.winner + 1);
  s.run_id = reinterpret_cast<int*>(s.run_val + k);
  s.new_val = reinterpret_cast<float*>(s.run_id + k);
  s.new_id = reinterpret_cast<int*>(s.new_val + k);
  return s;
}

__device__ inline void init_running(const Tile& s, int k) {
  for (int i = threadIdx.x; i < k; i += THREADS) {
    s.run_val[i] = NEG_INF;
    s.run_id[i] = 0;
  }
}

__device__ inline void zero_tile(const Tile& s, int n) {
  for (int i = threadIdx.x; i < n; i += THREADS) s.scores[i] = 0.0f;
}

// Fold the tile's n scores (docs lo .. lo + n - 1) into the running top-k.
// Call after a barrier that ends the scatter; ends with a barrier.
__device__ void merge_tile(const Tile& s, int n, int lo, int k) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  // Element u of the union: u < k is running entry u, else doc lo + u - k.
  const int total = k + n;
  float best_v;
  int best_id, best_u;
  auto rescan = [&]() {
    best_v = -INFINITY;  // below NEG_INF: marks "nothing left"
    best_id = INT_MAX;
    best_u = -1;
    for (int u = tid; u < total; u += THREADS) {
      const float v = u < k ? s.run_val[u] : s.scores[u - k];
      const int id = u < k ? s.run_id[u] : lo + u - k;
      if (better(v, id, best_v, best_id)) {
        best_v = v;
        best_id = id;
        best_u = u;
      }
    }
  };
  rescan();
  for (int r = 0; r < k; ++r) {
    float v = best_v;
    int id = best_id, u = best_u;
    warp_best(v, id, u);
    if (lane == 0) {
      s.warp_val[warp] = v;
      s.warp_id[warp] = id;
      s.warp_u[warp] = u;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < WARPS ? s.warp_val[lane] : -INFINITY;
      id = lane < WARPS ? s.warp_id[lane] : INT_MAX;
      u = lane < WARPS ? s.warp_u[lane] : -1;
      warp_best(v, id, u);
      if (lane == 0) {
        s.new_val[r] = v;
        s.new_id[r] = id;
        *s.winner = u;
        if (u >= 0 && u < k) s.run_val[u] = -INFINITY;  // taken
        if (u >= k) s.scores[u - k] = -INFINITY;
      }
    }
    __syncthreads();
    const int taken = *s.winner;
    if (taken >= 0 && taken % THREADS == tid) rescan();
  }
  for (int i = tid; i < k; i += THREADS) {
    s.run_val[i] = s.new_val[i];
    s.run_id[i] = s.new_id[i];
  }
  __syncthreads();
}

__device__ inline void write_out(const Tile& s, float* vals, int* idx,
                                 int k) {
  for (int i = threadIdx.x; i < k; i += THREADS) {
    vals[(size_t)blockIdx.x * k + i] = s.run_val[i];
    idx[(size_t)blockIdx.x * k + i] = s.run_id[i];
  }
}

__global__ void __launch_bounds__(THREADS)
    impact_topk_kernel(const float* __restrict__ w,
                       const int* __restrict__ docs, float* __restrict__ vals,
                       int* __restrict__ idx, float* lists, int W,
                       int seg_len, int n_docs, int k, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Tile s = carve(smem, tile, k, lists);
  const int tid = threadIdx.x;
  const float* wrow = w + (size_t)blockIdx.x * W;
  const int* drow = docs + (size_t)blockIdx.x * W;

  init_running(s, k);
  for (int lo = 0; lo < n_docs; lo += tile) {
    const int n = min(tile, n_docs - lo);
    zero_tile(s, n);
    __syncthreads();
    for (int s0 = 0; s0 < W; s0 += seg_len) {
      const int s1 = min(W, s0 + seg_len);
      for (int l = s0 + tid; l < s1; l += THREADS) {
        const float x = wrow[l];
        const int d = drow[l] - lo;
        if (x != 0.0f && d >= 0 && d < n) atomicAdd(s.scores + d, x);
      }
      __syncthreads();
    }
    merge_tile(s, n, lo, k);
  }
  write_out(s, vals, idx, k);
}

__global__ void __launch_bounds__(THREADS)
    impact_q_topk_kernel(const int* __restrict__ byte_win,
                         const int* __restrict__ gap_win,
                         const int* __restrict__ starts,
                         const int* __restrict__ lens,
                         const float* __restrict__ qv,
                         const float* __restrict__ lo_w,
                         const float* __restrict__ step,
                         float* __restrict__ vals, int* __restrict__ idx,
                         float* lists, int Q, int L, int n_docs, int k,
                         int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int warp_total[WARPS];   // each warp's sum of the chunk's gaps
  __shared__ int warp_prefix[WARPS];  // inclusive prefix of warp_total
  const Tile s = carve(smem, tile, k, lists);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  init_running(s, k);
  for (int lo = 0; lo < n_docs; lo += tile) {
    const int n = min(tile, n_docs - lo);
    zero_tile(s, n);
    __syncthreads();
    for (int t = 0; t < Q; ++t) {
      const size_t m = (size_t)blockIdx.x * Q + t;
      const float q = qv[m];
      const int len = min(lens[m], L);
      // the same for every thread of the block, so no barrier is skipped
      // by some threads only
      if (!(q > 0.0f) || len <= 0) continue;
      const int start = starts[m];
      const float a = lo_w[m];
      const float st = step[m];
      const int* bytes = byte_win + m * L;
      const int* gaps = gap_win + m * L;
      int carry = 0;  // the sum of this term's gaps before the chunk
      for (int c0 = 0; c0 < len; c0 += THREADS) {
        const int l = c0 + tid;
        const bool valid = l < len;
        const int x = warp_scan(valid ? gaps[l] : 0, lane);
        if (lane == 31) warp_total[warp] = x;
        __syncthreads();
        if (warp == 0) {
          const int y = warp_scan(lane < WARPS ? warp_total[lane] : 0, lane);
          if (lane < WARPS) warp_prefix[lane] = y;
        }
        // The barrier also orders this term's adds after the last term's:
        // every thread passes it only after finishing the earlier chunk.
        __syncthreads();
        const int doc = carry + (warp > 0 ? warp_prefix[warp - 1] : 0) + x;
        carry += warp_prefix[WARPS - 1];
        if (valid) {
          const int b = bytes[l];
          const int code = ((start + l) & 1) ? (b >> 4) : (b & 0xF);
          if (code > 0) {
            const float wt = __fmul_rn(
                __fadd_rn(a, __fmul_rn((float)(code - 1), st)), q);
            const int d = doc - lo;
            if (wt != 0.0f && d >= 0 && d < n) atomicAdd(s.scores + d, wt);
          }
        }
      }
    }
    __syncthreads();
    merge_tile(s, n, lo, k);
  }
  write_out(s, vals, idx, k);
}

// The tile (every doc up to TILE_MAX) and, when they fit beside it, the
// lists in shared memory; `in_ws`: the lists go to the workspace.
void plan(int n_docs, int k, int* tile, size_t* smem, bool* in_ws) {
  *tile = n_docs < TILE_MAX ? n_docs : TILE_MAX;
  *in_ws = tile_bytes(*tile) + lists_bytes(k) > SMEM_MAX;
  *smem = tile_bytes(*tile) + (*in_ws ? 0 : lists_bytes(k));
}

// ws: the workspace, used when the lists do not fit in shared memory
template <typename Kernel>
int prepare(Kernel kernel, int n_docs, int k, void* ws, int* tile,
            size_t* smem, float** lists) {
  bool in_ws;
  plan(n_docs, k, tile, smem, &in_ws);
  *lists = in_ws ? static_cast<float*>(ws) : nullptr;
  if (in_ws && ws == nullptr) return (int)cudaErrorInvalidValue;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
}

}  // namespace

// The device workspace both entry points need for B query rows, in bytes:
// 0 when the running lists fit in shared memory beside the doc tile, else
// B * 4 * k floats. -1 for arguments they do not take.
extern "C" long long impact_topk_workspace(int B, int n_docs, int k) {
  if (B < 1 || n_docs < 1 || k < 1) return -1;
  int tile;
  size_t smem;
  bool in_ws;
  plan(n_docs, k, &tile, &smem, &in_ws);
  return in_ws ? (long long)B * (long long)lists_bytes(k) : 0;
}

// C entry points, bound with ctypes. Each returns cudaGetLastError() after
// the launch. Both require B >= 1, n_docs >= 1 and k >= 1, and a workspace
// ws of impact_topk_workspace(B, n_docs, k) bytes (null when that is 0).
//
// K4: w f32 and docs i32 are (B, W) row-major; vals f32 and idx i32 are
// (B, k). seg_len (>= 1) is the lanes per query term.
extern "C" int impact_topk(const float* w, const int* docs, float* vals,
                           int* idx, void* ws, int B, int W, int seg_len,
                           int n_docs, int k, void* stream) {
  if (B < 1 || seg_len < 1 || n_docs < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  int tile;
  size_t smem;
  float* lists;
  const int err =
      prepare(impact_topk_kernel, n_docs, k, ws, &tile, &smem, &lists);
  if (err != (int)cudaSuccess) return err;
  impact_topk_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      w, docs, vals, idx, lists, W, seg_len, n_docs, k, tile);
  return (int)cudaGetLastError();
}

// K5: byte_win and gap_win i32 are (B, Q, L) row-major; starts, lens i32 and
// qv, lo, step f32 are (B, Q); vals f32 and idx i32 are (B, k). Q and L may
// be 0.
extern "C" int impact_q_topk(const int* byte_win, const int* gap_win,
                             const int* starts, const int* lens,
                             const float* qv, const float* lo,
                             const float* step, float* vals, int* idx,
                             void* ws, int B, int Q, int L, int n_docs, int k,
                             void* stream) {
  if (B < 1 || Q < 0 || L < 0 || n_docs < 1 || k < 1)
    return (int)cudaErrorInvalidValue;
  int tile;
  size_t smem;
  float* lists;
  const int err =
      prepare(impact_q_topk_kernel, n_docs, k, ws, &tile, &smem, &lists);
  if (err != (int)cudaSuccess) return err;
  impact_q_topk_kernel<<<B, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      byte_win, gap_win, starts, lens, qv, lo, step, vals, idx, lists, Q, L,
      n_docs, k, tile);
  return (int)cudaGetLastError();
}
