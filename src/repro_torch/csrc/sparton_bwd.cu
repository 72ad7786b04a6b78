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
// without atomics: every output element is owned by one thread, which sums
// its terms in a fixed order (ascending v for dH, ascending b for dE and
// db) and writes the element once. Two launches on the same inputs give
// the same bits. Terms with g == 0 (y == 0: the SPLADE rep is zero there,
// or the row is fully masked) are skipped, and H and E are read only where
// g != 0.
//
// K2 design. One block owns (batch row b, a range of at most S_TILE rows of
// S, a slice of DS = 64 columns of D; 32 where 64 columns of the whole S do
// not fit) and keeps dH[b, range, slice] as an f32 accumulator in shared
// memory (rows * DS * 4 bytes: 128 KB for 512 rows). Its 8 warps each own
// the rows s with s % 8 == warp, and each lane DS / 32 neighbouring columns
// of them. The block walks v in ascending order in rounds of 1024: all
// threads compute g and the routed row for the round into shared memory
// (coalesced, once per block; an entry routed outside the block's range is
// dropped there), then every warp scans the round 32 entries at a time,
// takes the ballot of the non-zero entries routed to its rows, loads the E
// values of up to 16 of them at once and adds g * E[v, col] into their rows
// in ascending v. An accumulator element is thus touched by one lane only,
// in ascending v, whatever the tiling: a sequence longer than one
// accumulator (S > 1728) is cut into ranges that each re-read g and i_max
// (B * V * 8 bytes a range) and give the same bits as one block would.
// Only such launches take the tiled form (its range test and offsets); a
// sequence that fits one accumulator runs the untiled one.
// Batches are launched in chunks of at most 65535 rows (grid.y).
//
// K3 design. One block owns (32 vocab rows, 64 columns); each thread owns
// one vocab row and 8 consecutive columns, with the sums in registers. The
// block walks b in ascending order in rounds of 32 rows: all threads stage
// g and i_max of the round in shared memory (coalesced), then each thread
// gathers the H rows of 8 batch rows at once (16-byte loads where D and
// the base allow) and adds them in b order. The threads of column group 0
// in the blocks of the first column tile also sum db[v].
//
// Bound on the H100: both kernels do 2 * nnz(g) * D FLOP in f32 (about 15
// GFLOP at the paper's Table-1 shape, 0.2 ms at 67 TFLOP/s) and must move
// dy, y, i_max (B * V * 12 bytes), E or H, and dH (B * S * D * 4 bytes) or
// dE: about 0.2 ms at 3.35 TB/s. They are bound by their gathers instead:
// K2 reads a row of E for every term (B * nnz * D * 2 bytes, 13 GB at the
// train shape, mostly from L2) and K3 a row of H for every term. Tiling
// several batch rows per K2 block (sharing each E row) and reusing H rows
// across the vocab rows that route to them are the road to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// K2
constexpr int ROUND = 1024;  // v staged per round
constexpr int AHEAD = 16;    // E loads in flight before their adds

// K3
constexpr int VT = 32;                  // vocab rows per block
constexpr int CPT = 8;                  // columns per thread
constexpr int DT = THREADS / VT * CPT;  // 64 columns per block
constexpr int BROUND = 32;              // batch rows staged per round
constexpr int UNROLL = 8;               // gathers in flight before their adds

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

struct Rows {            // (B, V) f32 / i32 rows of the backward's inputs
  const float* dy;
  const float* y;
  const int* imax;
  int B, S, D, V;
  int has_cap;
  float cap;
  int s_tile;            // K2: rows of S a block accumulates
};

// ---------------------------------------------------------------------------
// K2: dH
// ---------------------------------------------------------------------------

// CPL consecutive values of E's row at p (n of them live, n <= CPL) into out;
// VEC: n == CPL and p is aligned to CPL elements
template <int CPL, bool VEC>
__device__ __forceinline__ void load_e(const float* p, int n, float* out) {
  if (VEC && CPL == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    out[0] = q.x;
    out[CPL - 1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k) out[k] = k < n ? p[k] : 0.0f;
  }
}

template <int CPL, bool VEC>
__device__ __forceinline__ void load_e(const __nv_bfloat16* p, int n,
                                       float* out) {
  if (VEC && CPL == 2) {
    const float2 q =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
    out[0] = q.x;
    out[CPL - 1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < CPL; ++k)
      out[k] = k < n ? __bfloat162float(p[k]) : 0.0f;
  }
}

// TILED: the launch cuts S into ranges (blockIdx.z); a launch with one
// range takes the untiled form, which skips the range test and offsets.
template <typename T, int CPL, bool VEC, bool TILED>
__global__ void __launch_bounds__(THREADS)
    dh_kernel(const T* __restrict__ E, float* __restrict__ dH, Rows r) {
  constexpr int DS = 32 * CPL;    // columns per block
  extern __shared__ float acc[];  // (rows, DS)
  __shared__ float g_round[ROUND];
  __shared__ int s_round[ROUND];  // the row a term adds into, or -1
  const int b = blockIdx.y;
  const int s_lo = TILED ? blockIdx.z * r.s_tile : 0;
  const int rows = TILED ? min(r.s_tile, r.S - s_lo) : r.S;
  const int d0 = blockIdx.x * DS;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c = lane * CPL;           // this lane's first column
  const int n = min(CPL, r.D - d0 - c);  // its live columns (<= 0: none)

  for (int i = threadIdx.x; i < rows * DS; i += THREADS) acc[i] = 0.0f;

  const size_t row = (size_t)b * r.V;
  const T* e_col = E + d0 + c;
  float* acc_col = acc + c;
  for (int v0 = 0; v0 < r.V; v0 += ROUND) {
    __syncthreads();  // the last round is consumed (and acc zeroed)
    for (int k = threadIdx.x; k < ROUND; k += THREADS) {
      const int v = v0 + k;
      float g = 0.0f;
      int s = -1;
      if (v < r.V) {
        g = bwd_factor(r.y[row + v], r.dy[row + v], r.has_cap, r.cap);
        const int si = r.imax[row + v];
        // an i_max outside [0, S) routes nowhere, as in the reference's
        // segment sum (and never touches memory outside the accumulator);
        // one outside this block's range is another block's
        if (g != 0.0f && (unsigned)si < (unsigned)r.S &&
            (!TILED || (unsigned)(si - s_lo) < (unsigned)rows))
          s = si;
      }
      g_round[k] = g;
      s_round[k] = s;
    }
    __syncthreads();

    int word = 0;
    unsigned hits = 0;
    while (true) {  // warp-uniform: every lane sees the same ballots
      int js[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        while (hits == 0 && word < ROUND / 32) {
          const int s = s_round[word * 32 + lane];
          hits = __ballot_sync(FULL, s >= 0 && (s & (WARPS - 1)) == warp);
          ++word;
        }
        js[u] = hits ? (word - 1) * 32 + __ffs(hits) - 1 : -1;  // ascending v
        hits &= hits - 1;
      }
      if (js[0] < 0) break;
      float e[AHEAD][CPL];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (js[u] >= 0 && n > 0)
          load_e<CPL, VEC>(e_col + (size_t)(v0 + js[u]) * r.D, n, e[u]);
      }
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        if (js[u] < 0) break;
        if (n <= 0) continue;
        const float g = g_round[js[u]];
        float* a = acc_col + (s_round[js[u]] - s_lo) * DS;
        if (CPL == 2 && n == 2) {
          float2 cur = *reinterpret_cast<float2*>(a);
          cur.x += g * e[u][0];
          cur.y += g * e[u][CPL - 1];
          *reinterpret_cast<float2*>(a) = cur;
        } else {
#pragma unroll
          for (int k = 0; k < CPL; ++k)
            if (k < n) a[k] += g * e[u][k];
        }
      }
    }
  }
  __syncthreads();

  float* out = dH + ((size_t)b * r.S + s_lo) * r.D + d0;
  for (int i = threadIdx.x; i < rows * DS; i += THREADS) {
    const int sl = i / DS;
    const int col = i % DS;
    if (d0 + col < r.D) out[(size_t)sl * r.D + col] = acc[i];
  }
}

// ---------------------------------------------------------------------------
// K3: dE and db
// ---------------------------------------------------------------------------

// CPT values of p[0 .. n) into out (zeros past n); VEC: n == CPT and p is
// 16-byte aligned
template <bool VEC>
__device__ __forceinline__ void load_cols(const float* p, int n, float* out) {
  if (VEC) {
#pragma unroll
    for (int k = 0; k < CPT; k += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + k);
      out[k] = q.x;
      out[k + 1] = q.y;
      out[k + 2] = q.z;
      out[k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) out[k] = k < n ? p[k] : 0.0f;
  }
}

template <bool VEC>
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p, int n,
                                          float* out) {
  if (VEC) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < CPT / 2; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      out[2 * j] = f.x;
      out[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) out[k] = k < n ? __bfloat162float(p[k]) : 0.0f;
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(THREADS)
    de_kernel(const T* __restrict__ H, float* __restrict__ dE,
              float* __restrict__ db, Rows r) {
  __shared__ float g_round[BROUND][VT];
  __shared__ int s_round[BROUND][VT];  // i_max, or -1 where nothing gathers
  const int v0 = blockIdx.x * VT;
  const int vl = threadIdx.x / (DT / CPT);
  const int cg = threadIdx.x % (DT / CPT);
  const int v = v0 + vl;
  const int c0 = blockIdx.y * DT + cg * CPT;
  const int n = min(CPT, r.D - c0);  // columns of this thread (may be <= 0)

  float acc[CPT];
#pragma unroll
  for (int k = 0; k < CPT; ++k) acc[k] = 0.0f;
  float db_sum = 0.0f;

  for (int b0 = 0; b0 < r.B; b0 += BROUND) {
    __syncthreads();  // the last round is consumed
    for (int k = threadIdx.x; k < BROUND * VT; k += THREADS) {
      const int bi = k / VT;
      const int vv = k % VT;
      float g = 0.0f;
      int s = -1;
      if (b0 + bi < r.B && v0 + vv < r.V) {
        const size_t bv = (size_t)(b0 + bi) * r.V + v0 + vv;
        g = bwd_factor(r.y[bv], r.dy[bv], r.has_cap, r.cap);
        const int si = r.imax[bv];
        // an i_max outside [0, S) gathers nothing (never reads outside H)
        if (g != 0.0f && (unsigned)si < (unsigned)r.S) s = si;
      }
      g_round[bi][vv] = g;
      s_round[bi][vv] = s;
    }
    __syncthreads();

    const int nb = min(BROUND, r.B - b0);
    for (int bi = 0; bi < nb; bi += UNROLL) {
      float g[UNROLL];
      int s[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const bool in = bi + u < nb;
        g[u] = in ? g_round[bi + u][vl] : 0.0f;
        s[u] = in ? s_round[bi + u][vl] : -1;
      }
      float h[UNROLL][CPT];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        if (s[u] >= 0 && n > 0)
          load_cols<VEC>(H + ((size_t)(b0 + bi + u) * r.S + s[u]) * r.D + c0,
                         n, h[u]);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {  // ascending b
        db_sum += g[u];
        if (s[u] >= 0 && n > 0) {
#pragma unroll
          for (int k = 0; k < CPT; ++k) acc[k] += g[u] * h[u][k];
        }
      }
    }
  }

  if (v >= r.V) return;
  float* out = dE + (size_t)v * r.D + c0;
#pragma unroll
  for (int k = 0; k < CPT; ++k)
    if (k < n) out[k] = acc[k];
  if (blockIdx.y == 0 && cg == 0) db[v] = db_sum;
}

// the largest shared-memory accumulator a K2 block may take (of 227 KB,
// beside its 8 KB round of g and rows)
constexpr size_t DH_SMEM_MAX = 216 * 1024;
constexpr int MAX_GRID_Y = 65535;  // batch rows a K2 launch takes

// S cut into the fewest ranges of at most `fit` rows, all of one size
int s_tile(int S, int fit) {
  const int n = (S + fit - 1) / fit;
  return (S + n - 1) / n;
}

// One launch per chunk of at most MAX_GRID_Y batch rows; the blocks of a
// chunk cover its rows, the D slices and (TILED) the S ranges.
template <typename T, int CPL, bool VEC, bool TILED>
int launch_dh_cols(const T* E, float* dH, Rows r, cudaStream_t stream) {
  constexpr int DS = 32 * CPL;
  r.s_tile = TILED ? s_tile(r.S, (int)(DH_SMEM_MAX / (DS * sizeof(float))))
                   : r.S;
  const size_t smem = (size_t)r.s_tile * DS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      dh_kernel<T, CPL, VEC, TILED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int B = r.B;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    Rows c = r;
    const size_t off = (size_t)b0 * r.V;
    c.dy = r.dy + off;
    c.y = r.y + off;
    c.imax = r.imax + off;
    c.B = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    dim3 grid((r.D + DS - 1) / DS, c.B, (r.S + r.s_tile - 1) / r.s_tile);
    dh_kernel<T, CPL, VEC, TILED><<<grid, THREADS, smem, stream>>>(
        E, dH + (size_t)b0 * r.S * r.D, c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// 64 columns a block (two a lane, paired loads where vec) where the
// accumulator of the whole S fits, else 32 (in as many S ranges as it
// takes)
template <typename T>
int launch_dh(const void* E, float* dH, Rows r, int vec, cudaStream_t stream) {
  const T* e = static_cast<const T*>(E);
  if (r.D > 32 && (size_t)r.S * 64 * sizeof(float) <= DH_SMEM_MAX) {
    return vec ? launch_dh_cols<T, 2, true, false>(e, dH, r, stream)
               : launch_dh_cols<T, 2, false, false>(e, dH, r, stream);
  }
  if ((size_t)r.S * 32 * sizeof(float) <= DH_SMEM_MAX)
    return launch_dh_cols<T, 1, false, false>(e, dH, r, stream);
  return launch_dh_cols<T, 1, false, true>(e, dH, r, stream);
}

template <typename T, bool VEC>
int launch_de(const void* H, float* dE, float* db, Rows r,
              cudaStream_t stream) {
  dim3 grid((r.V + VT - 1) / VT, (r.D + DT - 1) / DT);
  de_kernel<T, VEC><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(H),
                                                  dE, db, r);
  return (int)cudaGetLastError();
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
  r.s_tile = S;
  return r;
}

bool bad_shape(int B, int S, int D, int V) {
  return B < 1 || S < 1 || D < 1 || V < 1;
}

}  // namespace

// C entry points, bound with ctypes. dy, y f32 (B, V); imax i32 (B, V), every
// entry in [0, S); dtype: 0 = float32, 1 = bfloat16 (of E, resp. H).
// softcap <= 0 means no cap. Each returns cudaGetLastError() after its launch.

// K2: dH f32 (B, S, D). vec: paired loads of E (the wrapper sets it when D
// is even and E is 8-byte aligned).
extern "C" int sparton_bwd_dh(const float* dy, const float* y, const int* imax,
                              const void* E, float* dH, int B, int S, int D,
                              int V, int dtype, float softcap, int vec,
                              void* stream) {
  if (bad_shape(B, S, D, V)) return (int)cudaErrorInvalidValue;
  const Rows r = make_rows(dy, y, imax, B, S, D, V, softcap);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch_dh<__nv_bfloat16>(E, dH, r, vec, st);
  if (dtype == 0) return launch_dh<float>(E, dH, r, vec, st);
  return (int)cudaErrorInvalidValue;
}

// K3: dE f32 (V, D), db f32 (V,). vec: 16-byte loads of H rows (the wrapper
// sets it when D is a multiple of 8 and H is 16-byte aligned).
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
