// Fused Sparton LM-head forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/sparton.py:_fwd_kernel
// (entry sparton_forward). It computes, per (batch row b, vocab id v),
//
//     y[b, v]     = log1p(relu(max_s z[b, s, v]))
//     i_max[b, v] = first s reaching that max
//     z[b, s, v]  = mask[b, s] ? softcap(H[b, s, :] . E[v, :] + bias[v]) : NEG_INF
//
// without ever writing the (B, S, V) logits to device memory.
//
// Bound on the H100: at the paper's Table-1 shape (B=320, S=512, D=768,
// V=30522) the GEMM is 7.68 TFLOP against 0.38 GB of compulsory traffic,
// so the kernel is compute-bound (about 7.8 ms at 989 TFLOP/s bf16).
//
// Three paths, chosen by the caller (kernels/sparton.py:_plan) and passed
// in as `path`; none gives way to another.
//
// "tma" (bf16, D % 8 == 0, 16-byte aligned bases: every launch of the
// serving and training paths). A persistent, warp-specialised wgmma
// kernel, one block of 384 threads per SM, blocks paired in clusters:
//   * A block owns an output tile of (bb batch rows x 256 vocab columns)
//     and walks S in chunks of 128 flattened (b, s) rows: bs positions of
//     bb = 128 / bs batch rows, bs the smallest power of two >= min(S,
//     128), at least 16. So each warp's 16 rows of a wgmma fragment lie in
//     one batch row.
//   * The two blocks of a cluster take two row groups on the same vocab
//     tile. Each loads its own H slice and half of the E slice, the half
//     multicast by TMA into both blocks, so the bytes read from L2 fall by
//     a third; a stage is refilled once the consumers of both blocks have
//     released it.
//   * Warpgroup 0 is the producer: one thread issues TMA loads of 64-wide
//     D slices (128 bytes, 128-byte swizzle) of H (a 3-D map over (D, S,
//     B), box (64, bs, bb), zeros past S and B) and E (a 2-D map over (D,
//     V), box (64, 128), zeros past V) into a 4-stage ring (48 KB a stage)
//     guarded by full/empty mbarriers. It runs straight across chunk and
//     tile boundaries, so the ring never drains. setmaxnreg moves its
//     registers (down to 40) to the consumers (232).
//   * Warpgroups 1 and 2 each take 128 of the tile's 256 columns for all
//     128 rows of a chunk: two wgmma.m64n128k16 (bf16 in, f32 accumulate,
//     both operands in shared memory) per k16 step. A stage is released
//     once wgmma.wait_group shows its reads done.
//   * Epilogue in registers: each accumulator gets bias[v], the softcap
//     and mask[b, s] before any max (the softcap is a template parameter,
//     so the main path's kernel carries no tanh code). When bs == 128 a
//     thread's four rows are positions of one batch row: it folds them in
//     ascending s into a running (max, s) of its 32 columns, kept in
//     registers across chunks, with no shuffle until the tile's end; a
//     chunk whose four rows are all masked is skipped. With smaller bs its
//     two fragments are two batch rows: each folds its two rows and the 8
//     lanes sharing a column reduce-scatter (shfl.xor 16, 8, 4) so that a
//     lane keeps 4 columns a fragment. At the tile's end the warps of one
//     batch row merge through shared memory and y, i_max are stored once.
//     Every merge keeps the larger value, then the smaller s, so ties go
//     to the first s, as in the reference. The two consumer warpgroups
//     share nothing but the ring (a named barrier each), so one's
//     epilogue may run beside the other's products.
//   * The grid is one block per SM walking cluster tiles in bands of
//     `group` row-group pairs, pair fastest: the clusters in flight share
//     E tiles, and a band's rows of H stay in L2 while it sweeps the
//     vocabulary. The C entry works the geometry out (chunks, band,
//     grid); nothing else does.
//   * Every chunk is loaded and multiplied, masked or not: the mask
//     enters only the epilogue (PERF.md says why masked chunks are not
//     skipped).
//   * What bounds it (PERF.md has the runs): the products, at the clock
//     the card holds under them. Without the cluster the TMA loads from L2
//     took most of the kernel's time; with it they take less than the
//     products, and the epilogue hides mostly behind them. While the
//     products run, a 700 W H100 reaches its power limit and lowers its SM
//     clock.
//
// "wmma" (the other bf16 inputs: D % 8 != 0 or a base that is not 16-byte
// aligned; also forced on aligned inputs to time the earlier design) and
// "f32". One block per (bb batch rows x 128 vocab) tile, launched in
// chunks of 65535 batch rows. Each chunk's logit tile is a GEMM over D in
// 32-wide slices: bf16 on the tensor cores (WMMA 16x16x16) fed by a
// 4-deep cp.async ring where rows may be copied 16 bytes at a time,
// element by element otherwise; f32 as an 8x8 register tile of FMAs per
// thread. The accumulators go through shared memory once per chunk into a
// running max/argmax per (batch row, column) in registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

namespace wmma_ring {

constexpr int BM = 128;       // rows of the flattened (b, s) tile
constexpr int BN = 128;       // vocab columns per block
constexpr int BK = 32;        // D slice staged per step
constexpr int THREADS = 256;  // 8 warps
constexpr float NEG_INF = -1e30f;

// shared-memory leading dimensions (padding keeps WMMA pointers 32-byte
// aligned and spreads the f32 path's column reads over the banks)
constexpr int LD_BF16 = BK + 8;   // 40 bf16 = 80 bytes per row
constexpr int LD_F32 = BK + 1;    // 33 floats: conflict-free column walk
constexpr int LD_C = BN + 4;      // 132 floats per accumulator row

constexpr int STAGES = 4;         // depth of the bf16 path's cp.async ring
constexpr int STAGE_ELEMS = (BM + BN) * LD_BF16;  // A rows, then E rows

// bf16: the ring of STAGES (A | E) slices; the f32 accumulator tile of a
// chunk aliases it once the chunk's D loop is done. f32: one A | E slice
// and a separate accumulator tile.
constexpr size_t smem_bytes(bool bf16) {
  return bf16 ? (size_t)STAGES * STAGE_ELEMS * sizeof(__nv_bfloat16)
              : (size_t)(BM + BN) * LD_F32 * sizeof(float) +
                    (size_t)BM * LD_C * sizeof(float);
}
static_assert((size_t)BM * LD_C * sizeof(float) <= smem_bytes(true),
              "the accumulator tile must fit in the bf16 ring");

struct Problem {
  const float* bias;
  const int* mask;
  float* y;
  int* imax;
  int B, S, D, V;
  int bs;          // sequence positions per chunk (power of two, <= BM)
  int bb;          // batch rows per block = BM / bs
  int vec;         // bf16 rows of H and E may be copied 16 bytes at a time
  int has_cap;
  float cap;
};

// The source row of tile row `row`: rows < BM are flattened (b, s) rows of
// H (b0 + row / bs, s0 + row % bs), the rest are rows v0 + row - BM of E.
// nullptr when the row lies outside the problem (it then reads as zero).
template <typename T>
__device__ __forceinline__ const T* tile_row(const T* __restrict__ H,
                                             const T* __restrict__ E,
                                             const Problem& p, int row,
                                             int b0, int s0, int v0) {
  if (row < BM) {
    const int b = b0 + row / p.bs;
    const int s = s0 + row % p.bs;
    return b < p.B && s < p.S ? H + ((size_t)b * p.S + s) * p.D : nullptr;
  }
  const int v = v0 + row - BM;
  return v < p.V ? E + (size_t)v * p.D : nullptr;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Stage the D slice [k0, k0 + BK) of the tile's BM A rows and BN E rows
// into one (A | E) ring slot. With p.vec each thread issues asynchronous
// 16-byte copies (zero-filled past the problem's edge); otherwise it
// copies element by element, synchronously.
__device__ __forceinline__ void load_stage(const __nv_bfloat16* __restrict__ H,
                                           const __nv_bfloat16* __restrict__ E,
                                           __nv_bfloat16* slot,
                                           const Problem& p, int b0, int s0,
                                           int v0, int k0) {
  constexpr int VECS_PER_ROW = BK / 8;
  for (int idx = threadIdx.x; idx < (BM + BN) * VECS_PER_ROW;
       idx += THREADS) {
    const int row = idx / VECS_PER_ROW;
    const int kv = (idx % VECS_PER_ROW) * 8;
    const __nv_bfloat16* src = tile_row(H, E, p, row, b0, s0, v0);
    __nv_bfloat16* dst = slot + row * LD_BF16 + kv;
    const int k = k0 + kv;
    if (p.vec) {  // D % 8 == 0, so k < D means all 8 elements are in range
      const bool in = src != nullptr && k < p.D;
      cp_async16(dst, in ? src + k : H, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = src != nullptr && k + e < p.D ? src[k + e]
                                                : __float2bfloat16(0.0f);
    }
  }
}

// The f32 path's synchronous staging of one D slice into As | Bs.
__device__ __forceinline__ void load_tiles(const float* __restrict__ H,
                                           const float* __restrict__ E,
                                           float* As, float* Bs,
                                           const Problem& p, int b0, int s0,
                                           int v0, int k0) {
  for (int idx = threadIdx.x; idx < (BM + BN) * BK; idx += THREADS) {
    const int row = idx / BK;
    const int k = k0 + idx % BK;
    const float* src = tile_row(H, E, p, row, b0, s0, v0);
    float* dst = row < BM ? As + row * LD_F32 : Bs + (row - BM) * LD_F32;
    dst[idx % BK] = src != nullptr && k < p.D ? src[k] : 0.0f;
  }
}

// One chunk's (BM x BN) logit tile on the tensor cores: 8 warps in a 4 x 2
// grid, each owning 32 rows x 64 columns = 2 x 4 fragments. The D slices
// stream through a STAGES-deep cp.async ring: while the tensor cores work
// on slice kt, the copies of slices kt + 1 .. kt + STAGES - 1 are in
// flight. The tile ends in Cs, which aliases the ring.
__device__ __forceinline__ void chunk_logits(const __nv_bfloat16* __restrict__ H,
                                             const __nv_bfloat16* __restrict__ E,
                                             __nv_bfloat16* ring, float* Cs,
                                             const Problem& p, int b0, int s0,
                                             int v0) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 2;
  const int wn = warp % 2;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  const int n_k = (p.D + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k)
      load_stage(H, E, ring + st * STAGE_ELEMS, p, b0, s0, v0, st * BK);
    cp_async_commit();  // one group per slice, empty ones included
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of slice kt landed
    __syncthreads();  // everyone's did, and slice kt - 1 is consumed
    const int next = kt + STAGES - 1;
    if (next < n_k)
      load_stage(H, E, ring + (next % STAGES) * STAGE_ELEMS, p, b0, s0, v0,
                 next * BK);
    cp_async_commit();
    const __nv_bfloat16* As = ring + (kt % STAGES) * STAGE_ELEMS;
    const __nv_bfloat16* Bs = As + BM * LD_BF16;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> bf[4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LD_BF16 + kk,
                               LD_BF16);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::load_matrix_sync(bf[j], Bs + (wn * 64 + j * 16) * LD_BF16 + kk,
                               LD_BF16);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is read out before Cs overwrites it
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LD_C + wn * 64 + j * 16,
                              acc[i][j], LD_C, wmma::mem_row_major);
}

// The f32 path: each thread accumulates an 8 x 8 register tile at rows
// tm + 16 i and columns tn + 16 j.
__device__ __forceinline__ void chunk_logits(const float* __restrict__ H,
                                             const float* __restrict__ E,
                                             float* As, float* Bs, float* Cs,
                                             const Problem& p, int b0, int s0,
                                             int v0) {
  const int tm = threadIdx.x / 16;
  const int tn = threadIdx.x % 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < p.D; k0 += BK) {
    load_tiles(H, E, As, Bs, p, b0, s0, v0, k0);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = As[(tm + 16 * i) * LD_F32 + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) b[j] = Bs[(tn + 16 * j) * LD_F32 + k];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      Cs[(tm + 16 * i) * LD_C + tn + 16 * j] = acc[i][j];
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    sparton_fwd_kernel(const T* __restrict__ H, const T* __restrict__ E,
                       Problem p) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr bool kBf16 = sizeof(T) == 2;
  T* As = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(
      kBf16 ? smem : smem + (size_t)(BM + BN) * LD_F32 * sizeof(float));

  const int v0 = blockIdx.x * BN;
  const int b0 = blockIdx.y * p.bb;

  // Thread t owns column c = t % BN for the batch rows t / BN + 2 j,
  // j < bb / 2 (bb <= 8, so at most four (b, v) outputs per thread).
  const int c = threadIdx.x % BN;
  const int bl0 = threadIdx.x / BN;
  const int v = v0 + c;
  const float bias = v < p.V ? p.bias[v] : 0.0f;
  float run_max[4];
  int run_arg[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    run_max[j] = NEG_INF;
    run_arg[j] = 0;
  }

  for (int s0 = 0; s0 < p.S; s0 += p.bs) {
    if constexpr (kBf16) {
      chunk_logits(H, E, As, Cs, p, b0, s0, v0);
    } else {
      chunk_logits(H, E, As, As + BM * LD_F32, Cs, p, b0, s0, v0);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bl = bl0 + 2 * j;
      const int b = b0 + bl;
      if (bl >= p.bb || b >= p.B) continue;
      const int s_end = min(p.bs, p.S - s0);
      const float* crow = Cs + (bl * p.bs) * LD_C + c;
      const int* mrow = p.mask + (size_t)b * p.S + s0;
      for (int sl = 0; sl < s_end; ++sl) {
        float x = crow[sl * LD_C] + bias;
        if (p.has_cap) x = p.cap * tanhf(x / p.cap);
        if (mrow[sl] == 0) x = NEG_INF;
        if (x > run_max[j]) {  // strict: the first s keeps a tie
          run_max[j] = x;
          run_arg[j] = s0 + sl;
        }
      }
    }
    __syncthreads();  // Cs is read out before the next chunk reuses it
  }

  if (v >= p.V) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int bl = bl0 + 2 * j;
    const int b = b0 + bl;
    if (bl >= p.bb || b >= p.B) continue;
    p.y[(size_t)b * p.V + v] = log1pf(fmaxf(run_max[j], 0.0f));
    p.imax[(size_t)b * p.V + v] = run_arg[j];
  }
}

constexpr int MAX_CHUNK = 65535;  // batch rows a launch takes (grid.y)

// One launch per chunk of at most MAX_CHUNK batch rows: the output rows are
// independent, so the chunks give the bits of a single launch.
template <typename T>
int launch(const void* H, const void* E, Problem p, cudaStream_t stream) {
  const size_t smem = smem_bytes(sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      sparton_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int B = p.B;
  const Problem whole = p;
  for (int b0 = 0; b0 < B; b0 += MAX_CHUNK) {
    p.B = B - b0 < MAX_CHUNK ? B - b0 : MAX_CHUNK;
    p.mask = whole.mask + (size_t)b0 * p.S;
    p.y = whole.y + (size_t)b0 * p.V;
    p.imax = whole.imax + (size_t)b0 * p.V;
    dim3 grid((p.V + BN - 1) / BN, (p.B + p.bb - 1) / p.bb);
    sparton_fwd_kernel<T><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(H) + (size_t)b0 * p.S * p.D,
        static_cast<const T*>(E), p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace wmma_ring

// ===========================================================================
// The "tma" path
// ===========================================================================

namespace tma {

using namespace hopper;

constexpr int ROWS = 128;               // flattened (b, s) rows per chunk
constexpr int BN = 256;                 // vocab columns per tile
constexpr int WG_COLS = 128;            // of them per consumer warpgroup
constexpr int BK = 64;                  // D slice per stage: 128 bytes
constexpr int STAGES = 4;
constexpr int CLUSTER = 2;              // blocks sharing each E slice
constexpr int THREADS = 384;            // producer + two consumer warpgroups
constexpr int PRODUCERS = 128;
constexpr int CONSUMER_WARPS = 8;
constexpr int A_BYTES = ROWS * BK * 2;  // H rows of one stage: 16 KB
constexpr int B_BYTES = BN * BK * 2;    // E rows of one stage: 32 KB
constexpr int E_PART = B_BYTES / CLUSTER;  // the E rows each block loads
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
constexpr float NEG_INF = -1e30f;
constexpr int ENCODE_FAILED = 10000;    // + the CUresult of the encoding
// rows of H that one band of the tile order keeps in L2 (of its 50 MB)
// while it sweeps all of E
constexpr long long L2_BAND_BYTES = 12ll << 20;

// byte offsets from the 1024-aligned base of dynamic shared memory: the
// ring, then the tile-end merge buffer of 8 row blocks x BN columns
// (value, s), the tile's bias, and the full/empty barriers
constexpr uint32_t OFF_A = 0;
constexpr uint32_t OFF_B = OFF_A + STAGES * A_BYTES;
constexpr uint32_t OFF_MVAL = OFF_B + STAGES * B_BYTES;
constexpr uint32_t OFF_MARG = OFF_MVAL + CONSUMER_WARPS * BN * 4;
constexpr uint32_t OFF_BIAS = OFF_MARG + CONSUMER_WARPS * BN * 4;
constexpr uint32_t OFF_BARS = OFF_BIAS + BN * 4;
constexpr uint32_t SMEM = OFF_BARS + 2 * STAGES * 8 + 1024;

struct Problem {
  const float* bias;
  const int* mask;
  float* y;
  int* imax;
  int B, S, D, V;
  int bs, bb;      // positions per chunk, batch rows per tile
  int n_rg, n_vt;  // row groups (bb batch rows each) and vocab tiles
  int n_rp;        // pairs of row groups, one pair to a cluster tile
  int group;       // pairs per band of the tile order
  long long n_tiles;  // n_rp * n_vt cluster tiles
  int has_cap;
  float cap;
};

// Cluster tile t of the persistent walk -> (row-group pair, vocab tile):
// bands of `group` pairs, the pair fastest within a band. Block r of a
// cluster takes row group CLUSTER * pair + r (the last one again, storing
// nothing, past n_rg).
__device__ __forceinline__ void tile_coords(long long t, const Problem& p,
                                            int& rp, int& vt) {
  const long long band_tiles = (long long)p.group * p.n_vt;
  const long long band = t / band_tiles;
  const long long local = t - band * band_tiles;
  const long long left = p.n_rp - band * p.group;
  const int rows = (int)(left < p.group ? left : p.group);
  vt = (int)(local / rows);
  rp = (int)(band * p.group + local % rows);
}

// Keep the larger value, then the smaller s: associative, so partial
// states over disjoint positions may meet in any order.
__device__ __forceinline__ void merge(float& bv, int& bs, float v, int s) {
  if (v > bv || (v == bv && s < bs)) {
    bv = v;
    bs = s;
  }
}

// One reduce-scatter step between the lanes that differ in `bit`: the
// entries [0, N) become [0, N / 2), the upper half on the lane with the
// bit set, each merged with the partner's copy.
template <int N>
__device__ __forceinline__ void scatter(float* v, int* s, int bit,
                                        bool upper) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) {
    const float send_v = upper ? v[i] : v[N / 2 + i];
    const int send_s = upper ? s[i] : s[N / 2 + i];
    float keep_v = upper ? v[N / 2 + i] : v[i];
    int keep_s = upper ? s[N / 2 + i] : s[i];
    const float other_v = __shfl_xor_sync(0xffffffffu, send_v, bit);
    const int other_s = __shfl_xor_sync(0xffffffffu, send_s, bit);
    merge(keep_v, keep_s, other_v, other_s);
    v[i] = keep_v;
    s[i] = keep_s;
  }
}

// The logit of one accumulator: bias, softcap, then the mask.
template <bool CAP>
__device__ __forceinline__ float logit(float acc, float bias, bool keep,
                                       float cap) {
  float x = acc + bias;
  if constexpr (CAP) x = cap * tanhf(x / cap);
  return keep ? x : NEG_INF;
}

// One fragment's two rows (positions s_0 < s_1 of one batch row) when a
// chunk holds several batch rows: 8 column groups at a time, fold the two
// rows (the earlier keeps a tie), merge over the 8 lanes that share a
// column, each lane keeping 2 of the 16 entries (lane l: columns 64 g +
// 8 (l / 4) + 2 (l % 4) + i), then into the fragment's running state
// run[2 g + i] (a later chunk: strictly greater).
template <bool CAP>
__device__ __forceinline__ void fold_fragment(const float (&acc)[64],
                                              const float* bias, bool k0,
                                              bool k1, int s_0, int s_1,
                                              int lane, float cap,
                                              float* run_v, int* run_s) {
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    float v[16];
    int s[16];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const int j = 8 * g + jj;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float b = bias[8 * j + 2 * (lane % 4) + e];
        const float x0 = logit<CAP>(acc[4 * j + e], b, k0, cap);
        const float x1 = logit<CAP>(acc[4 * j + 2 + e], b, k1, cap);
        const bool second = x1 > x0;
        v[2 * jj + e] = second ? x1 : x0;
        s[2 * jj + e] = second ? s_1 : s_0;
      }
    }
    scatter<16>(v, s, 16, lane & 16);
    scatter<8>(v, s, 8, lane & 8);
    scatter<4>(v, s, 4, lane & 4);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (v[i] > run_v[2 * g + i]) {
        run_v[2 * g + i] = v[i];
        run_s[2 * g + i] = s[i];
      }
    }
  }
}

// FULL's epilogue for one chunk: for each of the thread's 32 columns, fold
// its four rows (positions at[0] < .. < at[3] of one batch row, the
// earliest keeping a tie) and fold that into the running state (a later
// chunk: strictly greater). MASKED: some of the four rows are masked.
template <bool CAP, bool MASKED>
__device__ __forceinline__ void fold_rows(const float (&lo)[64],
                                          const float (&hi)[64],
                                          const float* bias, int lane,
                                          float cap, bool ka, bool kb,
                                          bool kc, bool kd, const int (&at)[4],
                                          float* run_v, int* run_s) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = bias[8 * j + 2 * (lane % 4) + e];
      const float x[4] = {
          logit<CAP>(lo[4 * j + e], b, !MASKED || ka, cap),
          logit<CAP>(lo[4 * j + 2 + e], b, !MASKED || kb, cap),
          logit<CAP>(hi[4 * j + e], b, !MASKED || kc, cap),
          logit<CAP>(hi[4 * j + 2 + e], b, !MASKED || kd, cap)};
      float best = x[0];
      int s = at[0];
#pragma unroll
      for (int r = 1; r < 4; ++r) {
        if (x[r] > best) {
          best = x[r];
          s = at[r];
        }
      }
      if (best > run_v[2 * j + e]) {
        run_v[2 * j + e] = best;
        run_s[2 * j + e] = s;
      }
    }
  }
}

// A consumer warp is done with a stage: one arrival on the stage's empty
// barrier in each block of the cluster.
__device__ __forceinline__ void release(uint32_t empty) {
#pragma unroll
  for (int cta = 0; cta < CLUSTER; ++cta) mbar_arrive_cluster(empty, cta);
}

// FULL: bs == 128, so a chunk's 128 rows are positions of one batch row.
// CAP: a softcap is applied.
template <bool FULL, bool CAP>
__global__ void __launch_bounds__(THREADS, 1)
    tma_kernel(const __grid_constant__ CUtensorMap hmap,
               const __grid_constant__ CUtensorMap emap, const Problem p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_addr(smem);
  float* mval = reinterpret_cast<float*>(smem + OFF_MVAL);
  int* marg = reinterpret_cast<int*>(smem + OFF_MARG);
  float* sbias = reinterpret_cast<float*>(smem + OFF_BIAS);
  const uint32_t full0 = base + OFF_BARS;  // stage i: full0 + 8 i
  const uint32_t empty0 = full0 + 8 * STAGES;

  // A stage of block r holds its own H rows and both halves of the E
  // slice: half r from its own multicast, the other from its partner's.
  // So its full barrier waits for all STAGE_BYTES, and its empty barrier
  // for the consumer warps of both blocks (the partner writes into it).
  const uint32_t rank = cluster_rank();
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(full0 + 8 * i, 1);
      mbar_init(empty0 + 8 * i, CLUSTER * CONSUMER_WARPS);
    }
    mbar_fence_init();
  }
  cluster_sync();  // both blocks' barriers exist before either is touched
  const int n_k = (p.D + BK - 1) / BK;
  const long long cluster = blockIdx.x / CLUSTER;
  const long long n_clusters = gridDim.x / CLUSTER;

  if (threadIdx.x < PRODUCERS) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      tma_prefetch(&hmap);
      tma_prefetch(&emap);
      int stage = 0;
      uint32_t phase = 0;
      for (long long t = cluster; t < p.n_tiles; t += n_clusters) {
        int rp, vt;
        tile_coords(t, p, rp, vt);
        const int rg = min(CLUSTER * rp + (int)rank, p.n_rg - 1);
        for (int s0 = 0; s0 < p.S; s0 += p.bs) {
          for (int k = 0; k < n_k; ++k) {
            mbar_wait(empty0 + 8 * stage, phase ^ 1);
            const uint32_t full = full0 + 8 * stage;
            mbar_expect_tx(full, STAGE_BYTES);
            tma_load_3d(base + OFF_A + stage * A_BYTES, &hmap, full, k * BK,
                        s0, rg * p.bb);
            tma_load_2d_multicast(
                base + OFF_B + stage * B_BYTES + rank * E_PART, &emap, full,
                k * BK, vt * BN + (int)rank * (BN / CLUSTER),
                (uint16_t)((1u << CLUSTER) - 1));
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
      // Wait for both blocks' consumers to release the last uses of every
      // stage: no arrival from the partner reaches this block after it
      // has exited.
      for (int i = 0; i < STAGES; ++i) {
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: all 128 rows of a chunk by 128 columns ----
    setmaxnreg_inc<232>();
    const int wg = (threadIdx.x - PRODUCERS) / 128;  // columns 128 wg + ..
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32;
    const int lane = tid % 32;
    // rows ra, ra + 8 (the low fragment) and ra + 64, ra + 72 (the high)
    const int ra = 16 * warp + lane / 4;
    const int bl_lo = ra / p.bs;
    const int bl_hi = (ra + 64) / p.bs;  // == bl_lo when FULL
    const int sl_lo = ra % p.bs;
    const int sl_hi = (ra + 64) % p.bs;
    const uint32_t b_off = (uint32_t)wg * WG_COLS * BK * 2;
    const int col0 = WG_COLS * wg;  // this warpgroup's first tile column
    float acc_lo[64], acc_hi[64];
    // running (max, s): FULL, per thread for its 32 columns; otherwise per
    // fragment, 4 columns a lane after the chunk's reduce-scatter
    constexpr int KEEP = FULL ? 32 : 8;
    float run_v[KEEP];
    int run_s[KEEP];
    int stage = 0;
    uint32_t phase = 0;
    for (long long t = cluster; t < p.n_tiles; t += n_clusters) {
      int rp, vt;
      tile_coords(t, p, rp, vt);
      // an odd last row group: block 1 repeats block 0's rows (their E
      // slices are shared) and stores nothing
      const bool owned = CLUSTER * rp + (int)rank < p.n_rg;
      const int b0 = min(CLUSTER * rp + (int)rank, p.n_rg - 1) * p.bb;
      const int v0 = vt * BN;
      sbias[col0 + tid] =
          v0 + col0 + tid < p.V ? p.bias[v0 + col0 + tid] : 0.0f;
      // the bias is in place, and the last tile's merge buffer read out
      named_sync(1 + wg, 128);
      const int b_lo = b0 + bl_lo;
      const int b_hi = b0 + bl_hi;
      const int* m_lo = p.mask + (size_t)(b_lo < p.B ? b_lo : 0) * p.S;
      const int* m_hi = p.mask + (size_t)(b_hi < p.B ? b_hi : 0) * p.S;
#pragma unroll
      for (int i = 0; i < KEEP; ++i) {
        run_v[i] = NEG_INF;
        run_s[i] = 0;
      }
      for (int s0 = 0; s0 < p.S; s0 += p.bs) {
        const int sa = s0 + sl_lo, sb = sa + 8;
        const int sc = s0 + sl_hi, sd = sc + 8;
        const bool ka = b_lo < p.B && sa < p.S && __ldg(m_lo + sa) != 0;
        const bool kb = b_lo < p.B && sb < p.S && __ldg(m_lo + sb) != 0;
        const bool kc = b_hi < p.B && sc < p.S && __ldg(m_hi + sc) != 0;
        const bool kd = b_hi < p.B && sd < p.S && __ldg(m_hi + sd) != 0;
        int prev = 0;
        for (int k = 0; k < n_k; ++k) {
          mbar_wait(full0 + 8 * stage, phase);
          const uint64_t da = smem_desc(base + OFF_A + stage * A_BYTES);
          const uint64_t db =
              smem_desc(base + OFF_B + stage * B_BYTES + b_off);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < BK / 16; ++kk) {
            // rows 64 .. 127 start 8 KB (512 descriptor units) further
            Wgmma<128>::mma(acc_lo, da + 2 * kk, db + 2 * kk, (k | kk) != 0);
            Wgmma<128>::mma(acc_hi, da + 512 + 2 * kk, db + 2 * kk,
                            (k | kk) != 0);
          }
          wgmma_commit();
          if (k > 0) {  // the previous slice's products are done with it
            wgmma_wait<1>();
            if (lane == 0) release(empty0 + 8 * prev);
          }
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        if (lane == 0) release(empty0 + 8 * prev);
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          reg_fence(acc_lo[i]);
          reg_fence(acc_hi[i]);
        }

        // Thread columns: 8 j + 2 (lane % 4) + e of the warpgroup's 128;
        // acc[4 j + e] on the first row of a fragment, acc[4 j + 2 + e]
        // 8 rows below.
        if constexpr (FULL) {
          // Masked logits never replace the running state, so four masked
          // rows are skipped and four kept ones need no mask test.
          const int at[4] = {sa, sb, sc, sd};
          if (ka && kb && kc && kd) {
            fold_rows<CAP, false>(acc_lo, acc_hi, sbias + col0, lane, p.cap,
                                  ka, kb, kc, kd, at, run_v, run_s);
          } else if (ka || kb || kc || kd) {
            fold_rows<CAP, true>(acc_lo, acc_hi, sbias + col0, lane, p.cap,
                                 ka, kb, kc, kd, at, run_v, run_s);
          }
        } else {
          // a fragment masked on every lane of the warp changes nothing
          // (the test is warp-wide: the fold shuffles across lanes)
          if (__any_sync(0xffffffffu, ka || kb))
            fold_fragment<CAP>(acc_lo, sbias + col0, ka, kb, sa, sb, lane,
                               p.cap, run_v, run_s);
          if (__any_sync(0xffffffffu, kc || kd))
            fold_fragment<CAP>(acc_hi, sbias + col0, kc, kd, sc, sd, lane,
                               p.cap, run_v + 4, run_s + 4);
        }
      }

      // Tile end: each warp's running state into the merge buffer, row
      // block rb covering rows 16 rb .. 16 rb + 15 of a chunk; then the
      // warpgroup merges the row blocks of each batch row for its columns
      // and stores y and i_max once.
      if constexpr (FULL) {
        // merge over the 8 lanes that share a column: lane l keeps the
        // entries q = 4 (l / 4) + i, column 8 (q / 2) + 2 (l % 4) + q % 2
        scatter<32>(run_v, run_s, 16, lane & 16);
        scatter<16>(run_v, run_s, 8, lane & 8);
        scatter<8>(run_v, run_s, 4, lane & 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = 4 * (lane / 4) + i;
          const int col = col0 + 8 * (q / 2) + 2 * (lane % 4) + q % 2;
          mval[warp * BN + col] = run_v[i];
          marg[warp * BN + col] = run_s[i];
        }
      } else {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int rb = 4 * (r / 4) + warp;  // high fragment: 4 + warp
          const int col = col0 + 64 * ((r / 2) % 2) + 8 * (lane / 4) +
                          2 * (lane % 4) + r % 2;
          mval[rb * BN + col] = run_v[r];
          marg[rb * BN + col] = run_s[r];
        }
      }
      named_sync(1 + wg, 128);
      // the row blocks of batch row ob: FULL, the 4 warps' merged states;
      // otherwise blocks ob * bs / 16 .. (ob + 1) * bs / 16 - 1
      const int per_row = FULL ? 4 : p.bs / 16;
      for (int o = tid; o < p.bb * WG_COLS; o += 128) {
        const int ob = o / WG_COLS;
        const int col = col0 + o % WG_COLS;
        const int r0 = ob * per_row;
        float best_v = mval[r0 * BN + col];
        int best_s = marg[r0 * BN + col];
        for (int rb = r0 + 1; rb < r0 + per_row; ++rb)
          merge(best_v, best_s, mval[rb * BN + col], marg[rb * BN + col]);
        const int bo = b0 + ob;
        const int vo = v0 + col;
        if (owned && bo < p.B && vo < p.V) {
          p.y[(size_t)bo * p.V + vo] = log1pf(fmaxf(best_v, 0.0f));
          p.imax[(size_t)bo * p.V + vo] = best_s;
        }
      }
    }
  }
}

// Encode H's and E's tensor maps for this call and launch the persistent
// grid: as many clusters as the card holds at once, never more than tiles.
template <bool FULL, bool CAP>
int launch(const void* H, const void* E, Problem p, cudaStream_t stream) {
  CUtensorMap hmap, emap;
  const cuuint64_t h_sizes[3] = {(cuuint64_t)p.D, (cuuint64_t)p.S,
                                 (cuuint64_t)p.B};
  const cuuint64_t h_strides[2] = {(cuuint64_t)p.D * 2,
                                   (cuuint64_t)p.S * p.D * 2};
  const cuuint32_t h_box[3] = {BK, (cuuint32_t)p.bs, (cuuint32_t)p.bb};
  int rc = encode_bf16(&hmap, H, 3, h_sizes, h_strides, h_box);
  if (rc != 0) return ENCODE_FAILED + rc;
  const cuuint64_t e_sizes[2] = {(cuuint64_t)p.D, (cuuint64_t)p.V};
  const cuuint64_t e_strides[1] = {(cuuint64_t)p.D * 2};
  const cuuint32_t e_box[2] = {BK, BN / CLUSTER};
  rc = encode_bf16(&emap, E, 2, e_sizes, e_strides, e_box);
  if (rc != 0) return ENCODE_FAILED + rc;
  cudaError_t err = cudaFuncSetAttribute(
      tma_kernel<FULL, CAP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = CLUSTER;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CLUSTER);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // the clusters the card holds at once (asked once per device and
  // kernel): a persistent grid must be resident all together
  static int resident[64] = {0};
  int device = 0, clusters = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device >= 64 || resident[device] == 0) {
    err = cudaOccupancyMaxActiveClusters(&clusters, tma_kernel<FULL, CAP>,
                                         &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorInvalidConfiguration;
    if (device < 64) resident[device] = clusters;
  } else {
    clusters = resident[device];
  }
  cfg.gridDim = dim3(CLUSTER * (int)(p.n_tiles < clusters ? p.n_tiles
                                                          : clusters));
  err = cudaLaunchKernelEx(&cfg, tma_kernel<FULL, CAP>, hmap, emap, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace tma

// C entry point, bound with ctypes. path: 0 = "f32" (H and E float32),
// 1 = "wmma", 2 = "tma" (H and E bfloat16; "tma" needs D % 8 == 0 and
// 16-byte aligned bases). bias is f32 (V,), mask i32 (B, S); y f32 and
// i_max i32 (B, V). softcap <= 0 means no cap. Any B >= 1. Each path
// works out its own launch geometry here. Returns the first CUDA error,
// or 10000 + the CUresult when a tensor map cannot be encoded.
extern "C" int sparton_fwd(const void* H, const void* E, const float* bias,
                           const int* mask, float* y, int* imax, int B, int S,
                           int D, int V, int path, float softcap,
                           void* stream) {
  if (B < 1 || S < 1 || D < 1 || V < 1) {
    return (int)cudaErrorInvalidValue;
  }
  int bs = 16;
  while (bs < S && bs < 128) bs *= 2;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = D % 8 == 0 && (uintptr_t)H % 16 == 0 &&
                       (uintptr_t)E % 16 == 0;
  if (path == 2) {
    if (!aligned) return (int)cudaErrorInvalidValue;
    tma::Problem p;
    p.bias = bias;
    p.mask = mask;
    p.y = y;
    p.imax = imax;
    p.B = B;
    p.S = S;
    p.D = D;
    p.V = V;
    p.bs = bs;
    p.bb = tma::ROWS / bs;
    p.n_rg = (B + p.bb - 1) / p.bb;
    p.n_vt = (V + tma::BN - 1) / tma::BN;
    p.n_rp = (p.n_rg + tma::CLUSTER - 1) / tma::CLUSTER;
    // as many pairs to a band as keep their rows of H within
    // L2_BAND_BYTES, at least one
    const long long pair_bytes = (long long)tma::CLUSTER * p.bb * S * D * 2;
    const long long fit = tma::L2_BAND_BYTES / pair_bytes;
    p.group = (int)(fit < 1 ? 1 : fit < p.n_rp ? fit : p.n_rp);
    p.n_tiles = (long long)p.n_rp * p.n_vt;
    p.has_cap = softcap > 0.0f;
    p.cap = softcap;
    if (bs == tma::ROWS) {
      return p.has_cap ? tma::launch<true, true>(H, E, p, st)
                       : tma::launch<true, false>(H, E, p, st);
    }
    return p.has_cap ? tma::launch<false, true>(H, E, p, st)
                     : tma::launch<false, false>(H, E, p, st);
  }
  wmma_ring::Problem p;
  p.bias = bias;
  p.mask = mask;
  p.y = y;
  p.imax = imax;
  p.B = B;
  p.S = S;
  p.D = D;
  p.V = V;
  p.bs = bs;
  p.bb = wmma_ring::BM / bs;
  p.vec = path == 1 && aligned;
  p.has_cap = softcap > 0.0f;
  p.cap = softcap;
  if (path == 1) return wmma_ring::launch<__nv_bfloat16>(H, E, p, st);
  if (path == 0) return wmma_ring::launch<float>(H, E, p, st);
  return (int)cudaErrorInvalidValue;
}
