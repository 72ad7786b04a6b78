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
// Design. One block owns a (bb batch rows x BN vocab columns) output tile
// and walks the sequence in chunks of bs positions, bb * bs = BM = 128
// rows of the flattened (b, s) axis per chunk. Each chunk's (BM x BN)
// logit tile is a GEMM over D, staged through shared memory in BK-wide
// slices: for bf16 inputs a 4-deep ring of cp.async copies feeds the
// tensor cores (WMMA 16x16x16, bf16 in, f32 accumulate); f32 inputs take
// a synchronous slice and an 8x8 register tile of FMAs per thread. The
// accumulators go to shared memory once per chunk; the epilogue adds the
// bias, applies the softcap and the mask, and folds the chunk into a
// running max/argmax that each thread keeps in registers for the columns
// it owns. Positions are visited in ascending s and only a strictly
// greater value replaces the running one, so ties go to the first s,
// as in the reference. y and i_max are stored once, at the end; nothing
// carries over between blocks.
//
// Bound on the H100: at the paper's Table-1 shape (B=320, S=512, D=768,
// V=30522) the GEMM is 7.68 TFLOP against 0.38 GB of compulsory traffic,
// so the kernel is compute-bound (about 7.8 ms at 989 TFLOP/s bf16).
// This version hides load latency with the cp.async ring but issues
// mma.sync-class WMMA; wgmma, TMA and warp specialisation are the road
// to that bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

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

}  // namespace

// C entry point, bound with ctypes. dtype: 0 = float32, 1 = bfloat16 (H and
// E alike); bias is f32 (V,), mask i32 (B, S); y f32 and i_max i32 (B, V).
// softcap <= 0 means no cap. Any B >= 1 (launched in chunks of 65535 rows).
// Returns the first CUDA error of the launches.
extern "C" int sparton_fwd(const void* H, const void* E, const float* bias,
                           const int* mask, float* y, int* imax, int B, int S,
                           int D, int V, int dtype, float softcap, int vec,
                           void* stream) {
  if (B < 1 || S < 1 || D < 1 || V < 1) {
    return (int)cudaErrorInvalidValue;
  }
  Problem p;
  p.bias = bias;
  p.mask = mask;
  p.y = y;
  p.imax = imax;
  p.B = B;
  p.S = S;
  p.D = D;
  p.V = V;
  int bs = 16;
  while (bs < S && bs < BM) bs *= 2;
  p.bs = bs;
  p.bb = BM / bs;
  p.vec = vec;
  p.has_cap = softcap > 0.0f;
  p.cap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return launch<__nv_bfloat16>(H, E, p, st);
  if (dtype == 0) return launch<float>(H, E, p, st);
  return (int)cudaErrorInvalidValue;
}
