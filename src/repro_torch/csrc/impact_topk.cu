// Fused impact scoring with a streaming top-k for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/impact_score.py:
// _impact_kernel (entry fused_impact_topk). Per query row q it computes
//
//     score[d] = sum over lanes l with docs[q, l] == d of w[q, l]
//
// for every doc d < n_docs and returns the k best (value descending, doc
// id ascending), without writing the (B, n_docs) score matrix to device
// memory. When k > n_docs the tail holds (NEG_INF, 0), as in the reference.
//
// Design. One block per query row. It walks the doc range in tiles of up
// to TILE_MAX docs (one tile at the serving shape); a tile's scores live
// in shared memory. The posting lanes are scattered into the tile one
// segment at a time, a segment being one query term's posting window
// (seg_len lanes), with a barrier between segments. A doc occurs at most
// once in a term's posting list, so within a segment no two lanes add to
// the same doc: the shared-memory atomicAdd never contends, and each
// doc's sum is taken in lane order, bit for bit the reference's order.
// The tile is then merged into a running top-k of k entries, also in
// shared memory: k rounds of a block-wide arg-best over the union of the
// running entries and the tile, each round taking the best remaining
// (value, id) and marking it taken. Only the thread that owned the winner rescans its elements.
//
// Bound on the H100: the kernel reads each posting lane once (8 bytes:
// the f32 weight and the i32 doc id) and writes (B, k) results, so its
// floor is fused_window_bytes over 3.35 TB/s. At the serving shape only
// B blocks run, one per query, far from filling the 132 SMs: splitting a
// query's doc range across blocks is the next step.

#include <climits>
#include <cmath>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr float NEG_INF = -1e30f;
constexpr int TILE_MAX = 32768;  // docs scored per pass: 128 KB of f32

__device__ __forceinline__ bool better(float av, int ai, float bv, int bi) {
  return av > bv || (av == bv && ai < bi);
}

// Warp-wide arg-best of (value, id, owner slot); lane 0 ends with it.
__device__ __forceinline__ void warp_best(float& v, int& id, int& u) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, id, off);
    const int ou = __shfl_down_sync(0xffffffffu, u, off);
    if (better(ov, oi, v, id)) {
      v = ov;
      id = oi;
      u = ou;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    impact_topk_kernel(const float* __restrict__ w,
                       const int* __restrict__ docs, float* __restrict__ vals,
                       int* __restrict__ idx, int W, int seg_len, int n_docs,
                       int k, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* scores = reinterpret_cast<float*>(smem);   // (tile,)
  float* run_val = scores + tile;                    // (k,) running top-k
  int* run_id = reinterpret_cast<int*>(run_val + k);
  float* new_val = reinterpret_cast<float*>(run_id + k);  // (k,) next one
  int* new_id = reinterpret_cast<int*>(new_val + k);
  float* warp_val = reinterpret_cast<float*>(new_id + k);  // (WARPS,)
  int* warp_id = reinterpret_cast<int*>(warp_val + WARPS);
  int* warp_u = warp_id + WARPS;
  int* winner = warp_u + WARPS;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const float* wrow = w + (size_t)blockIdx.x * W;
  const int* drow = docs + (size_t)blockIdx.x * W;

  for (int i = tid; i < k; i += THREADS) {
    run_val[i] = NEG_INF;
    run_id[i] = 0;
  }

  for (int lo = 0; lo < n_docs; lo += tile) {
    const int n = min(tile, n_docs - lo);
    for (int i = tid; i < n; i += THREADS) scores[i] = 0.0f;
    __syncthreads();
    for (int s0 = 0; s0 < W; s0 += seg_len) {
      const int s1 = min(W, s0 + seg_len);
      for (int l = s0 + tid; l < s1; l += THREADS) {
        const float x = wrow[l];
        const int d = drow[l] - lo;
        if (x != 0.0f && d >= 0 && d < n) atomicAdd(scores + d, x);
      }
      __syncthreads();
    }

    // Element u of the union: u < k is running entry u, else doc lo + u - k.
    const int total = k + n;
    float best_v;
    int best_id, best_u;
    auto rescan = [&]() {
      best_v = -INFINITY;  // below NEG_INF: marks "nothing left"
      best_id = INT_MAX;
      best_u = -1;
      for (int u = tid; u < total; u += THREADS) {
        const float v = u < k ? run_val[u] : scores[u - k];
        const int id = u < k ? run_id[u] : lo + u - k;
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
        warp_val[warp] = v;
        warp_id[warp] = id;
        warp_u[warp] = u;
      }
      __syncthreads();
      if (warp == 0) {
        v = lane < WARPS ? warp_val[lane] : -INFINITY;
        id = lane < WARPS ? warp_id[lane] : INT_MAX;
        u = lane < WARPS ? warp_u[lane] : -1;
        warp_best(v, id, u);
        if (lane == 0) {
          new_val[r] = v;
          new_id[r] = id;
          *winner = u;
          if (u >= 0 && u < k) run_val[u] = -INFINITY;  // taken
          if (u >= k) scores[u - k] = -INFINITY;
        }
      }
      __syncthreads();
      const int taken = *winner;
      if (taken >= 0 && taken % THREADS == tid) rescan();
    }
    for (int i = tid; i < k; i += THREADS) {
      run_val[i] = new_val[i];
      run_id[i] = new_id[i];
    }
    __syncthreads();
  }

  for (int i = tid; i < k; i += THREADS) {
    vals[(size_t)blockIdx.x * k + i] = run_val[i];
    idx[(size_t)blockIdx.x * k + i] = run_id[i];
  }
}

}  // namespace

// C entry point, bound with ctypes. w f32 and docs i32 are (B, W) row-major;
// vals f32 and idx i32 are (B, k). seg_len is the lanes per query term.
// Requires B >= 1, seg_len >= 1, n_docs >= 1 and 1 <= k <= MAX_K (1024,
// the wrapper's limit too). Returns cudaGetLastError() after the launch.
extern "C" int impact_topk(const float* w, const int* docs, float* vals,
                           int* idx, int B, int W, int seg_len, int n_docs,
                           int k, void* stream) {
  constexpr int MAX_K = 1024;
  if (B < 1 || seg_len < 1 || n_docs < 1 || k < 1 || k > MAX_K)
    return (int)cudaErrorInvalidValue;
  const int tile = n_docs < TILE_MAX ? n_docs : TILE_MAX;
  const size_t smem = (size_t)tile * sizeof(float) +
                      (size_t)k * 4 * sizeof(float) +
                      (size_t)WARPS * 3 * sizeof(int) + sizeof(int);
  cudaError_t err = cudaFuncSetAttribute(
      impact_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  impact_topk_kernel<<<B, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      w, docs, vals, idx, W, seg_len, n_docs, k, tile);
  return (int)cudaGetLastError();
}
