// Fused vocab projection + weighted cross-entropy for Hopper (sm_90a),
// plain C interface.
//
// Replaces the TPU kernels of ecamp_tpu/kernels/fused_mlm_loss.py:
//   _fwd_kernel (launched by _fused_fwd):      lse, gold per row
//   _bwd_dx_kernel, _bwd_dw_kernel (launched by _fused_bwd_impl)
// over x (N, D), the decoder weight w (V, D) row-major (the port's Linear
// layout), the fp32 bias b (V,) and labels (N,):
//   logits = x w^T + b (fp32)
//   fwd:  lse = logsumexp(logits), gold = logits[label]        (fp32)
//   bwd:  dl = (softmax(logits) - onehot(label)) * wg   (wg = weights * g)
//         dx = dl' w,  dW = dl'^T x  with dl' = dl rounded to x's dtype,
//         db = colsum(dl) in fp32.
//
// What bounds it on the H100: at the pretraining shape (N = 8192, D = 768,
// V = 30000) the logits are 2NDV = 0.38 TFLOP and each of the backward's
// two products as much again, on 59 MB of operands: far above the ridge
// point, so it is compute-bound.
//
// bf16 with D % 8 == 0 and 16-byte aligned bases (the wrapper's shape
// rule) runs on the tensor cores: every kernel below is one GEMM of one
// mainloop (tc::gemm_body: TMA loads into a ring of 128-byte-swizzled
// tiles behind mbarriers, one producer thread, two consumer warpgroups
// running wgmma on 128 x BN tiles, a persistent grid) with its own
// epilogue, and hopper.cuh holds the primitives.
//
// Forward, two kernels:
//   tiles: S = x W^T over the whole vocabulary in 128 x 128 tiles; from the
//          accumulators, each row's tile max m and sum of exp(logit - m)
//          (base-2 exp, the bias folded in) into an fp32 partials buffer
//          (ceil(V / 128), N) x 2, and the gold logit from the one tile that
//          holds the row's label (no atomics); two blocks an SM, the vocab
//          tiles walked in the outer loop so that x stays in L2
//   merge: each row's partials folded in a fixed order into lse = m +
//          log(l) (blocks run in no order, so the Pallas kernel's online
//          fold across the grid does not carry over; a fixed order keeps
//          the result deterministic), and gold 0 for a label outside
//          [0, V)
// Backward: the vocabulary in chunks of Vc rows, three kernels a chunk:
//   dl:  S = x W_c^T (N x Vc over D); dl' into an (N, Vc) scratch and one
//        fp32 column sum of dl per 128 rows into a partials buffer; its K
//        is only D, so two blocks share an SM and one's epilogue runs
//        under the other's products
//   dx:  dx32 (+)= dl'_c W_c (N x D over Vc) in fp32; the last chunk
//        writes dx
//   dW:  dW_c = dl'_c^T x (Vc x D over N); db_c = the partials summed in
//        tile order (no atomics)
// Each logit is computed once (3 x 2NDV in all, the bound's count), no
// accumulator spans D, and the price is the scratch: dl' is written once
// and read twice. TMA's zero fill takes the ragged N, Vc, V and D edges.
// fp32, and bf16 of other widths or alignments, run on the FMA pipe. The
// forward: a block owns kOwn = 32 rows of x and streams the vocab in tiles
// of kStr = 128 rows, each 32 x 128 logit tile computed over D in
// shared-memory stages and folded into a running (max, sum-exp, gold) per
// row. The backward: a block owns 32 rows of one operand (x for dx, w for
// dW + db), recomputes each 32 x 128 logit tile against the streamed
// operand and accumulates its (32 x D) output in registers. The logits
// never reach device memory.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kOwn = 32;       // owned rows a block
constexpr int kStr = 128;      // streamed rows a tile
constexpr int kDMax = 768;     // widest D the register accumulators hold
constexpr int kPad = 4;        // fp32 rows: keeps 16 bytes, spreads banks
constexpr int kBK = 32;        // depth of one logit-tile stage
constexpr int kBK2 = 8;        // streamed rows of one accumulation stage
constexpr int kNJ = kDMax / 128;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// shared-memory stages

struct TileStage {  // FMA: one stage of the logit tile, k-major fp32
  float own[kBK][kOwn + kPad];
  float str[kBK][kStr + kPad];
};

struct AccStage {  // FMA: kBK2 streamed rows, the whole of D
  float str[kBK2][kDMax];
};

struct FmaSmem {
  union {  // never live at once
    TileStage tile;
    AccStage acc;
  } st;
  float dl[kOwn][kStr + kPad];  // dl' of the tile, [own][str], fp32
};

// ---------------------------------------------------------------------------
// the 32 x 128 logit tile, FMA pipe

// acc[i][j] = sum_k own[o0 + 4 ty + i][k] * str[t0 + 4 tx + j][k] over
// k < D, both operands row-major (rows of length D); rows at or past
// n_own / n_str read as zero. Ends with the block synchronised.
template <typename T>
__device__ __forceinline__ void logit_tile(const T* __restrict__ own, long long o0, int n_own,
                                           const T* __restrict__ str, long long t0, int n_str,
                                           int D, TileStage& s, float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int ty = tid / 32;
  const int tx = tid % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < D; k0 += kBK) {
    // a warp reads kBK consecutive elements of one row (coalesced) and
    // stores them down one column of the k-major stage
    for (int e = tid; e < kOwn * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      float v = 0.f;
      if (o0 + r < n_own && k0 + k < D) v = to_f(own[(o0 + r) * D + k0 + k]);
      s.own[k][r] = v;
    }
    for (int e = tid; e < kStr * kBK; e += kThreads) {
      const int r = e / kBK, k = e % kBK;
      float v = 0.f;
      if (t0 + r < n_str && k0 + k < D) v = to_f(str[(t0 + r) * D + k0 + k]);
      s.str[k][r] = v;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&s.own[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&s.str[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// epilogues of the FMA tiles (the (ty, tx) 4 x 4 layout)

// Fold a logit tile (bias not yet added) into each row's running max m,
// sum-exp l and gold logit g (one lane's share of the gold).
__device__ __forceinline__ void fwd_fold(float (&acc)[4][4], int v0, int V,
                                         const float* __restrict__ b, const long long (&lab)[4],
                                         float (&m)[4], float (&l)[4], float (&g)[4]) {
  const int tx = threadIdx.x % 32;
  float bias[4];
  bool ok[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int v = v0 + tx * 4 + j;
    ok[j] = v < V;
    bias[j] = ok[j] ? b[v] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float tmax = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float z = acc[i][j] + bias[j];
      acc[i][j] = z;
      if (ok[j]) {
        tmax = fmaxf(tmax, z);
        if (v0 + tx * 4 + j == lab[i]) g[i] += z;
      }
    }
    // column v0 is always inside V, so the tile max is finite
    const float m_new = fmaxf(m[i], warp_max(tmax));
    float p = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ok[j]) p += expf(acc[i][j] - m_new);
    l[i] = l[i] * expf(m[i] - m_new) + warp_sum(p);
    m[i] = m_new;
  }
}

// dl of a logit tile (bias not yet added); adds each owned row's share of
// colsum(dl) to dbsum (the dW kernel's db).
template <bool kVocabOwned>
__device__ __forceinline__ void tile_dl(const float (&z)[4][4], long long o0, long long t0,
                                        int N, int V, const float* __restrict__ b,
                                        const long long* __restrict__ labels,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ wg, float (&dl)[4][4],
                                        float (&dbsum)[4]) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long o = o0 + ty * 4 + i;
      const long long t = t0 + tx * 4 + j;
      const long long n = kVocabOwned ? t : o;
      const long long v = kVocabOwned ? o : t;
      float d = 0.f;
      if (n < N && v < V) {
        const float p = expf(z[i][j] + b[v] - lse[n]);
        d = (p - (labels[n] == v ? 1.f : 0.f)) * wg[n];
      }
      dbsum[i] += d;
      dl[i][j] = d;
    }
  }
}

// ---------------------------------------------------------------------------
// forward

// One block per 32 rows of x streams every vocab tile and keeps a running
// (max, sum-exp, gold) per row.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
fused_ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, const long long* __restrict__ labels,
                    float* __restrict__ lse, float* __restrict__ gold, int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  TileStage& s = *reinterpret_cast<TileStage*>(smem);
  const int ty = threadIdx.x / 32;
  const int tx = threadIdx.x % 32;
  const long long r0 = (long long)blockIdx.x * kOwn;

  float m[4], l[4], g[4];
  long long lab[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long r = r0 + ty * 4 + i;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
    g[i] = 0.f;
    lab[i] = r < N ? labels[r] : -1;
  }
  for (int v0 = 0; v0 < V; v0 += kStr) {
    float acc[4][4];
    logit_tile(x, r0, N, w, v0, V, D, s, acc);
    fwd_fold(acc, v0, V, b, lab, m, l, g);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float gi = warp_sum(g[i]);
    const long long r = r0 + ty * 4 + i;
    if (tx == 0 && r < N) {
      lse[r] = m[i] + logf(l[i]);
      gold[r] = gi;
    }
  }
}

// ---------------------------------------------------------------------------
// backward

// out[own] += dl' . str over kStr streamed rows, FMA pipe: acc[i][jj*4 + c]
// is column jj*128 + 4 tx + c of owned row 4 ty + i.
template <typename T>
__device__ __forceinline__ void fma_accumulate(const T* __restrict__ str, int t0, int n_str,
                                               int D, FmaSmem& sm, float (&acc)[kNJ * 16]) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
  for (int k0 = 0; k0 < kStr; k0 += kBK2) {
    // kBK2 streamed rows, all of D: consecutive threads, consecutive d
    for (int e = threadIdx.x; e < kBK2 * kDMax; e += kThreads) {
      const int k = e / kDMax, d = e % kDMax;
      const long long t = (long long)t0 + k0 + k;
      float v = 0.f;
      if (d < D && t < n_str) v = to_f(str[t * D + d]);
      sm.st.acc.str[k][d] = v;
    }
    __syncthreads();  // also publishes the dl tile on the first stage
#pragma unroll
    for (int k = 0; k < kBK2; ++k) {
      float a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sm.dl[ty * 4 + i][k0 + k];
#pragma unroll
      for (int jj = 0; jj < kNJ; ++jj) {
        if (jj * 128 >= D) break;
        const float4 bb = *reinterpret_cast<const float4*>(&sm.st.acc.str[k][jj * 128 + tx * 4]);
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i * kNJ * 4 + jj * 4 + c] = fmaf(a[i], bv[c], acc[i * kNJ * 4 + jj * 4 + c]);
      }
    }
    __syncthreads();
  }
}

template <typename T>
__device__ __forceinline__ void fma_store(const float (&acc)[kNJ * 16], long long o0, int n_own,
                                          int D, T* __restrict__ out) {
  const int ty = threadIdx.x / 32, tx = threadIdx.x % 32;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long o = o0 + ty * 4 + i;
    if (o >= n_own) continue;
#pragma unroll
    for (int jj = 0; jj < kNJ; ++jj)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = jj * 128 + tx * 4 + c;
        if (d < D) out[o * D + d] = from_f<T>(acc[i * kNJ * 4 + jj * 4 + c]);
      }
  }
}

// The FMA backward: dx (kVocabOwned = false) or dW + db (true). A block
// owns 32 rows of one operand and streams the other; for each streamed
// tile it recomputes the 32 x 128 logits, forms dl, and accumulates
// out[own] += dl' . str.
template <typename T, bool kVocabOwned>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, const long long* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ wg,
                    T* __restrict__ out, float* __restrict__ db, int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  FmaSmem& sm = *reinterpret_cast<FmaSmem*>(smem);
  const int ty = threadIdx.x / 32;
  const int tx = threadIdx.x % 32;
  const T* own = kVocabOwned ? w : x;
  const T* str = kVocabOwned ? x : w;
  const int n_own = kVocabOwned ? V : N;
  const int n_str = kVocabOwned ? N : V;
  const long long o0 = (long long)blockIdx.x * kOwn;

  float acc[kNJ * 16];
#pragma unroll
  for (int c = 0; c < kNJ * 16; ++c) acc[c] = 0.f;
  float dbsum[4] = {0.f, 0.f, 0.f, 0.f};

  for (int t0 = 0; t0 < n_str; t0 += kStr) {
    float z[4][4], dl[4][4];
    logit_tile(own, o0, n_own, str, t0, n_str, D, sm.st.tile, z);
    tile_dl<kVocabOwned>(z, o0, t0, N, V, b, labels, lse, wg, dl, dbsum);
#pragma unroll
    for (int i = 0; i < 4; ++i)  // dx and dW take dl in x's dtype
      *reinterpret_cast<float4*>(&sm.dl[ty * 4 + i][tx * 4]) =
          make_float4(to_f(from_f<T>(dl[i][0])), to_f(from_f<T>(dl[i][1])),
                      to_f(from_f<T>(dl[i][2])), to_f(from_f<T>(dl[i][3])));
    fma_accumulate(str, t0, n_str, D, sm, acc);
  }

  if (kVocabOwned) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = warp_sum(dbsum[i]);
      const long long o = o0 + ty * 4 + i;
      if (tx == 0 && o < n_own) db[o] = s;
    }
  }
  fma_store(acc, o0, n_own, D, out);
}

// ---------------------------------------------------------------------------
// launches

bool bad_shape(int N, int V, int D) { return N <= 0 || V <= 0 || D <= 0 || D > kDMax; }

// a launch's dynamic shared memory; above 48 KB only once allowed
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T>
int launch_fwd(const void* x, const void* w, const void* b, const void* labels, void* lse,
               void* gold, int N, int V, int D, cudaStream_t stream) {
  const int blocks = (N + kOwn - 1) / kOwn;
  const size_t smem = sizeof(TileStage);
  const cudaError_t err = allow_smem(fused_ce_fwd_kernel<T>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_kernel<T><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const long long*>(labels), static_cast<float*>(lse),
      static_cast<float*>(gold), N, V, D);
  return (int)cudaGetLastError();
}

template <typename T, bool kVocabOwned>
int launch_bwd(const void* x, const void* w, const void* b, const void* labels,
               const void* lse, const void* wg, void* out, void* db, int N, int V, int D,
               cudaStream_t stream) {
  const int blocks = ((kVocabOwned ? V : N) + kOwn - 1) / kOwn;
  const size_t smem = sizeof(FmaSmem);
  const cudaError_t err = allow_smem(fused_ce_bwd_kernel<T, kVocabOwned>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_ce_bwd_kernel<T, kVocabOwned><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
      static_cast<const long long*>(labels), static_cast<const float*>(lse),
      static_cast<const float*>(wg), static_cast<T*>(out), static_cast<float*>(db), N, V, D);
  return (int)cudaGetLastError();
}

template <bool kVocabOwned>
int dispatch_bwd(const void* x, const void* w, const void* b, const void* labels,
                 const void* lse, const void* wg, void* out, void* db, int N, int V, int D,
                 int dtype, cudaStream_t s) {
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch_bwd<bf16, kVocabOwned>(x, w, b, labels, lse, wg, out, db, N, V, D, s);
  if (dtype == 0)
    return launch_bwd<float, kVocabOwned>(x, w, b, labels, lse, wg, out, db, N, V, D, s);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// the tensor-core path: TMA + wgmma GEMMs (the forward over the whole
// vocabulary, the backward over vocab chunks)

namespace tc {

constexpr int kBM = 128;        // output rows a tile: 64 per consumer warpgroup
constexpr int kBK = 64;         // depth of one stage: 128 bytes of bf16, one swizzle row
// shared-memory ring: 3 stages of 32 KB for the 128-wide logit tiles (two
// blocks an SM), 4 of 40 KB for the 192-wide products (one)
template <int BN>
constexpr int kStagesOf = BN == 128 ? 3 : 4;
// The logit tiles are 128 wide and their K is only D, so an epilogue (exp,
// dl' stores, column sums) follows every 12 k-steps: two blocks share an SM
// so that one's epilogue overlaps the other's products.
constexpr int kDlBN = 128;
template <int BN>
constexpr int kCtasOf = BN == 128 ? 2 : 1;
// threads a block: two consumer warpgroups and a producer warpgroup whose
// registers move to the consumers (setmaxnreg), or, at two blocks an SM,
// a lone producer warp and at most 112 registers a thread throughout
template <int BN>
constexpr int kThreadsOf = kCtasOf<BN> == 1 ? 384 : 288;
constexpr int kConsumers = 256; // two consumer warpgroups
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBox = 64 * kBK * 2;  // one 64 x 64 bf16 TMA box, 8 KB

enum Epi { kEpiFwd, kEpiDl, kEpiDx, kEpiDw, kEpiGemm };

// What the epilogues read. C is M x N over K; B's map starts at row b_row0.
struct Args {
  int M, N, K, b_row0;
  int v0, ld;                    // chunk start in V; row stride of dl' and partials
  const float* bias;             // fwd, dl: fp32 (V,)
  const long long* labels;       // fwd, dl: (N,)
  float2* tile_stats;            // fwd: (ceil(V / 128), N) of (max, sum-exp)
  float* gold;                   // fwd: fp32 (N,)
  const float* lse;              // dl: fp32 (N,)
  const float* wg;               // dl: fp32 (N,)
  bf16* dl;                      // dl: dl' (N, ld)
  float* partials;               // dl writes, dW reads: (ceil(N / kBM), ld)
  int n_mtiles;                  // dW: rows of partials
  float* acc32;                  // dx: fp32 (N, D) across chunks
  bf16* out;                     // dx: dx (N, D); dW: dW (V, D)
  int first, last;               // dx: the chunk's place
  float* db;                     // dW: fp32 (V,)
  float* c;                      // the bare GEMM: fp32 (M, N)
};

// the two consumer warpgroups' own barrier (the producer never joins)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

template <int BN, int kTA, int kTB>
__device__ __forceinline__ void wgmma_step(float (&d)[BN / 2], uint64_t da, uint64_t db) {
  static_assert(BN == 128 || BN == 192, "tile widths of the three products");
  if constexpr (BN == 128)
    wgmma_m64n128<kTA, kTB>(d, da, db);
  else
    wgmma_m64n192<kTA, kTB>(d, da, db);
}

// Accumulator fragment i of a thread of a warpgroup: row 16 warp + lane/4
// + 8 ((i / 2) % 2), column 8 (i / 4) + 2 (lane % 4) + i % 2 of its 64 x BN.

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// The forward's tile of logits S (bias not yet added): each row's max m
// and sum of exp(logit - m) over the tile's columns inside V, in natural
// units, into tile_stats[n0 / BN][row] (rows n >= M are not written), and
// the gold logit of a row whose label lies in the tile. exp is one FMA and
// one ex2 an element, the bias folded in base 2 (m then converted); the
// logits are rewritten in place in base 2 for the second pass.
template <int BN>
__device__ __forceinline__ void epilogue_fwd(float (&acc)[BN / 2], int m0, int n0, int wgi,
                                             const Args& p) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32, q = lane % 4;
  int n[2];
  long long lab[2];
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    n[h] = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    lab[h] = n[h] < p.M ? p.labels[n[h]] - n0 : -1;  // the label's column in the tile
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = 8 * j + 2 * q + e;
      const bool ok = n0 + c < p.N;
      const float b = ok ? p.bias[n0 + c] : 0.f;
      const float b2 = b * kLog2e;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int i = 4 * j + 2 * h + e;
        if (ok && lab[h] == c) p.gold[n[h]] = acc[i] + b;
        acc[i] = ok ? fmaf(acc[i], kLog2e, b2) : -CUDART_INF_F;
        mx[h] = fmaxf(mx[h], acc[i]);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    // column n0 is always inside V, so the row's tile max is finite
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) sum[h] += ex2(acc[4 * j + 2 * h + e] - mx[h]);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    if (q == 0 && n[h] < p.M)
      p.tile_stats[(size_t)(n0 / BN) * p.M + n[h]] = make_float2(mx[h] * kLn2, sum[h]);
  }
}

// dl' = ((exp(S + b - lse) - onehot) * wg) rounded to bf16, and the tile's
// fp32 column sums of dl (rows n >= N and columns past the chunk are 0).
// exp is one FMA and one ex2 an element, the bias and lse folded in base 2;
// each column pair is summed over the warp's 16 rows as soon as it is done,
// so no array of sums stays live beside the accumulators.
template <int BN>
__device__ __forceinline__ void epilogue_dl(const float (&acc)[BN / 2], int m0, int n0, int wgi,
                                            const Args& p) {
  __shared__ float red[8][BN];  // column sums of each consumer warp's 16 rows
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32, q = lane % 4;
  bool rok[2];
  float l2[2], wgt[2];
  long long lab[2];
  bf16* row[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    rok[h] = n < p.M;
    l2[h] = rok[h] ? p.lse[n] * kLog2e : 0.f;
    wgt[h] = rok[h] ? p.wg[n] : 0.f;
    lab[h] = rok[h] ? p.labels[n] - p.v0 : -1;
    row[h] = p.dl + (size_t)n * p.ld;
  }
  consumers_sync();  // the previous tile's sums are read
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int c = n0 + 8 * j + 2 * q;
    float b2[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 2; ++e) b2[e] = c + e < p.N ? p.bias[p.v0 + c + e] * kLog2e : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float d[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        d[e] = 0.f;
        if (rok[h] && c + e < p.N) {
          const float pr = ex2(fmaf(acc[4 * j + 2 * h + e], kLog2e, b2[e] - l2[h]));
          d[e] = (pr - (lab[h] == c + e ? 1.f : 0.f)) * wgt[h];
        }
        sum[e] += d[e];
      }
      if (rok[h] && c + 1 < p.N)
        *reinterpret_cast<__nv_bfloat162*>(row[h] + c) = __floats2bfloat162_rn(d[0], d[1]);
      else if (rok[h] && c < p.N)
        row[h][c] = __float2bfloat16(d[0]);
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = sum[e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[wgi * 4 + warp][8 * j + 2 * q + e] = v;
    }
  }
  consumers_sync();
  if (tid < BN && n0 + tid < p.N) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < 8; ++r) s += red[r][tid];  // a fixed order
    p.partials[(size_t)(m0 / kBM) * p.ld + n0 + tid] = s;
  }
}

// dx: the first chunk stores its product, the others add theirs; the last
// writes dx in bf16. D % 8 == 0, so a column pair is whole.
template <int BN>
__device__ __forceinline__ void epilogue_dx(const float (&acc)[BN / 2], int m0, int n0, int wgi,
                                            const Args& p) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    if (n >= p.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c >= p.N) continue;
      const size_t o = (size_t)n * p.N + c;
      float2 v = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      if (!p.first) {
        const float2 old = *reinterpret_cast<const float2*>(p.acc32 + o);
        v.x += old.x;
        v.y += old.y;
      }
      if (p.last)
        *reinterpret_cast<__nv_bfloat162*>(p.out + o) = __floats2bfloat162_rn(v.x, v.y);
      else
        *reinterpret_cast<float2*>(p.acc32 + o) = v;
    }
  }
}

// dW rows v0 + m in bf16; the tiles of the first column tile also write db
// of their rows, the partial sums added in tile order.
template <int BN>
__device__ __forceinline__ void epilogue_dw(const float (&acc)[BN / 2], int m0, int n0, int wgi,
                                            const Args& p) {
  const int tid = threadIdx.x, warp = (tid % 128) / 32, lane = tid % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    if (m >= p.M) continue;
    bf16* row = p.out + (size_t)(p.v0 + m) * p.N;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c < p.N)
        *reinterpret_cast<__nv_bfloat162*>(row + c) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  if (n0 == 0 && tid < kBM && m0 + tid < p.M) {
    float s = 0.f;
    for (int i = 0; i < p.n_mtiles; ++i) s += p.partials[(size_t)i * p.ld + m0 + tid];
    p.db[p.v0 + m0 + tid] = s;
  }
}

// the bare GEMM's fp32 C (M, N), N % 8 == 0
template <int BN>
__device__ __forceinline__ void epilogue_gemm(const float (&acc)[BN / 2], int m0, int n0, int wgi,
                                              const Args& p) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = m0 + 64 * wgi + 16 * warp + lane / 4 + 8 * h;
    if (m >= p.M) continue;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int c = n0 + 8 * j + 2 * (lane % 4);
      if (c < p.N)
        *reinterpret_cast<float2*>(p.c + (size_t)m * p.N + c) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// One mainloop for the three products: C (M x N) = A (M x K) B (K x N) in
// 128 x BN tiles, a persistent grid walking the tiles. Warpgroups 0 and 1
// each own 64 rows of a tile and run wgmma from the ring; one thread of
// warpgroup 2 (a lone warp at two blocks an SM) keeps the ring full with
// TMA loads, running ahead into the next tile while the consumers run an
// epilogue.
//   A K-major (kAMN false): one box of 128 rows x 64 k.
//   A MN-major: two boxes of 64 k rows x 64 m (one per warpgroup).
//   B K-major: one box of BN rows x 64 k.  B MN-major: BN / 64 boxes of
//   64 k rows x 64 n.
// Every box is 128-byte swizzled with 128-byte rows: a K-major operand
// steps 16 k by 32 bytes inside the swizzle atom; an MN-major one by two
// 8-row atoms (2048 bytes), its 64-wide MN blocks 8 KB apart (LBO).
template <int BN, bool kAMN, bool kBMN, int kEpi>
__device__ __forceinline__ void gemm_body(const CUtensorMap& ta, const CUtensorMap& tb,
                                          const Args& p) {
  constexpr int kStage = kABytes + BN * kBK * 2;
  constexpr int kStages = kStagesOf<BN>;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the swizzle pattern repeats every 1024 bytes: stages start on it
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int wgi = threadIdx.x / 128;
  const int tiles_m = (p.M + kBM - 1) / kBM, tiles_n = (p.N + BN - 1) / BN;
  const int tiles = tiles_m * tiles_n;
  // tile t's origin: row tiles in the outer loop, or, for the forward (its
  // N is the whole vocabulary, its A only N x D), the column tiles, so
  // that a B tile is loaded from device memory once and A stays in L2
  auto origin = [&](int t, int& m0, int& n0) {
    if (kEpi == kEpiFwd) {
      m0 = t % tiles_m * kBM;
      n0 = t / tiles_m * BN;
    } else {
      m0 = t / tiles_n * kBM;
      n0 = t % tiles_n * BN;
    }
  };
  const int nk = (p.K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {  // producer
    if constexpr (kCtasOf<BN> == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      unsigned ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        int m0, n0;
        origin(t, m0, n0);
        for (int kt = 0; kt < nk; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], kStage);
          unsigned char* a = smem + s * kStage;
          unsigned char* b = a + kABytes;
          const int k0 = kt * kBK;
          if (kAMN) {
            tma_load(a, &ta, &full[s], m0, k0);
            tma_load(a + kBox, &ta, &full[s], m0 + 64, k0);
          } else {
            tma_load(a, &ta, &full[s], k0, m0);
          }
          if (kBMN) {
#pragma unroll
            for (int j = 0; j < BN / 64; ++j)
              tma_load(b + j * kBox, &tb, &full[s], n0 + 64 * j, p.b_row0 + k0);
          } else {
            tma_load(b, &tb, &full[s], k0, p.b_row0 + n0);
          }
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumers
    if constexpr (kCtasOf<BN> == 1) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[BN / 2];
    int s = 0, prev = 0;
    unsigned ph = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int m0, n0;
      origin(t, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      for (int kt = 0; kt < nk; ++kt) {
        mbar_wait(&full[s], ph);
        const unsigned char* a = smem + s * kStage;
        const unsigned char* b = a + kABytes;
        wg_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t da = kAMN ? sw128_desc(a + wgi * kBox + kk * 2048, kBox, 1024)
                                   : sw128_desc(a + wgi * kBox + kk * 32, 16, 1024);
          const uint64_t db = kBMN ? sw128_desc(b + kk * 2048, kBox, 1024)
                                   : sw128_desc(b + kk * 32, 16, 1024);
          wgmma_step<BN, kAMN ? 1 : 0, kBMN ? 1 : 0>(acc, da, db);
        }
        wg_commit();
        wg_wait<1>();  // the previous stage's products are done: free it
        if (kt > 0) mbar_arrive(&empty[prev]);
        prev = s;
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
      wg_wait<0>();
      fence_regs(acc);
      mbar_arrive(&empty[prev]);
      if constexpr (kEpi == kEpiFwd)
        epilogue_fwd<BN>(acc, m0, n0, wgi, p);
      else if constexpr (kEpi == kEpiDl)
        epilogue_dl<BN>(acc, m0, n0, wgi, p);
      else if constexpr (kEpi == kEpiDx)
        epilogue_dx<BN>(acc, m0, n0, wgi, p);
      else if constexpr (kEpi == kEpiDw)
        epilogue_dw<BN>(acc, m0, n0, wgi, p);
      else
        epilogue_gemm<BN>(acc, m0, n0, wgi, p);
    }
  }
}

}  // namespace tc

// S = x W^T (K-major both) over the whole vocabulary, epilogue tile stats
// and gold
__global__ void __launch_bounds__(tc::kThreadsOf<tc::kDlBN>, tc::kCtasOf<tc::kDlBN>)
fused_ce_fwd_tiles_kernel(const __grid_constant__ CUtensorMap ta,
                          const __grid_constant__ CUtensorMap tb, const tc::Args p) {
  tc::gemm_body<tc::kDlBN, false, false, tc::kEpiFwd>(ta, tb, p);
}

// (m, l) <- the fold of (m, l) and a tile's (max, sum-exp) s; a tile of
// none (s.y = 0) leaves it as it is
__device__ __forceinline__ void fold_stats(float& m, float& l, float2 s) {
  if (s.x > m) {
    l = l * expf(m - s.x) + s.y;
    m = s.x;
  } else if (s.y > 0.f) {
    l += s.y * expf(s.x - m);
  }
}

constexpr int kMergeRows = 32;   // rows a block: a warp's lanes
constexpr int kMergeGroups = 8;  // warps a block, each a share of the tiles
constexpr int kMergeLoads = 4;   // loads in flight a thread

// lse of each row from its tiles' (max, sum-exp); gold 0 for a label
// outside [0, V). Warp g of a block folds tiles g, g + 8, g + 16, ... of
// its 32 rows in that order (lanes on consecutive rows: coalesced loads,
// kMergeLoads in flight), then the 8 warps' results are folded in warp
// order: a fixed order, so the result is deterministic.
__global__ void __launch_bounds__(kMergeRows * kMergeGroups)
fused_ce_fwd_merge_kernel(const float2* __restrict__ tile_stats,
                          const long long* __restrict__ labels, float* __restrict__ lse,
                          float* __restrict__ gold, int N, int V, int tiles) {
  __shared__ float2 part[kMergeGroups][kMergeRows];
  const int r = threadIdx.x % kMergeRows, grp = threadIdx.x / kMergeRows;
  const int n = blockIdx.x * kMergeRows + r;
  float m = -CUDART_INF_F, l = 0.f;
  if (n < N) {
    for (int t0 = grp; t0 < tiles; t0 += kMergeLoads * kMergeGroups) {
      float2 s[kMergeLoads];
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i) {
        const int t = t0 + i * kMergeGroups;
        s[i] = t < tiles ? tile_stats[(size_t)t * N + n] : make_float2(-CUDART_INF_F, 0.f);
      }
#pragma unroll
      for (int i = 0; i < kMergeLoads; ++i) fold_stats(m, l, s[i]);
    }
  }
  part[grp][r] = make_float2(m, l);
  __syncthreads();
  if (grp != 0 || n >= N) return;
#pragma unroll
  for (int g = 1; g < kMergeGroups; ++g) fold_stats(m, l, part[g][r]);
  lse[n] = m + logf(l);
  const long long lab = labels[n];
  if (lab < 0 || lab >= V) gold[n] = 0.f;
}

// S = x W_c^T (K-major both), epilogue dl' and partial column sums
__global__ void __launch_bounds__(tc::kThreadsOf<tc::kDlBN>, tc::kCtasOf<tc::kDlBN>)
fused_ce_bwd_dl_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const tc::Args p) {
  tc::gemm_body<tc::kDlBN, false, false, tc::kEpiDl>(ta, tb, p);
}

// dx (+)= dl'_c W_c: A K-major, B (W rows, D contiguous) MN-major
__global__ void __launch_bounds__(tc::kThreadsOf<192>, tc::kCtasOf<192>)
fused_ce_bwd_dx_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const tc::Args p) {
  tc::gemm_body<192, false, true, tc::kEpiDx>(ta, tb, p);
}

// dW_c = dl'_c^T x: both MN-major; db_c from the partials
__global__ void __launch_bounds__(tc::kThreadsOf<192>, tc::kCtasOf<192>)
fused_ce_bwd_dw_kernel(const __grid_constant__ CUtensorMap ta,
                       const __grid_constant__ CUtensorMap tb, const tc::Args p) {
  tc::gemm_body<192, true, true, tc::kEpiDw>(ta, tb, p);
}

// the mainloop alone in one of the three operand layouts, for the tests
template <int kLayout>
__global__ void __launch_bounds__(kLayout == 0 ? tc::kThreadsOf<tc::kDlBN> : 384,
                                  kLayout == 0 ? tc::kCtasOf<tc::kDlBN> : 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, const tc::Args p) {
  tc::gemm_body<kLayout == 0 ? tc::kDlBN : 192, kLayout == 2, kLayout != 0, tc::kEpiGemm>(ta, tb,
                                                                                      p);
}

// one persistent launch: kCtasOf<BN> blocks for each SM, or one for each
// tile if fewer
template <int BN, typename Kernel>
int launch_tc(Kernel kernel, const CUtensorMap& ta, const CUtensorMap& tb, const tc::Args& p,
              cudaStream_t stream) {
  const int smem = tc::kStagesOf<BN> * (tc::kABytes + BN * tc::kBK * 2) + 1024;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.M + tc::kBM - 1) / tc::kBM * ((p.N + BN - 1) / BN);
  const int slots = sm_count() * tc::kCtasOf<BN>;
  if (slots <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<tiles < slots ? tiles : slots, tc::kThreadsOf<BN>, smem, stream>>>(ta, tb, p);
  return (int)cudaGetLastError();
}

bool chunk_ok(int N, int V, int D, int v0, int width, int ld) {
  return N > 0 && D > 0 && D % 8 == 0 && width > 0 && v0 >= 0 && v0 + width <= V &&
         ld >= width && ld % 8 == 0;
}

}  // namespace

// The FMA forward. x (N, D), w (V, D): contiguous, of `dtype` (0 = fp32,
// 1 = bf16); b (V,) fp32; labels (N,) int64; lse, gold (N,) fp32 outputs.
// D <= 768. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ecamp_fused_ce_fwd(const void* x, const void* w, const void* b,
                                  const void* labels, void* lse, void* gold, int N, int V,
                                  int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  if (dtype == 1) return launch_fwd<bf16>(x, w, b, labels, lse, gold, N, V, D, s);
  if (dtype == 0) return launch_fwd<float>(x, w, b, labels, lse, gold, N, V, D, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core forward, bf16, D % 8 == 0, 16-byte aligned x and w.
// Tiles: tile_stats (tiles, N) of fp32 (max, sum-exp) pairs for each
// 128-wide vocab tile, tiles = ceil(V / 128), and gold (N,) fp32 of the
// rows whose label lies in [0, V) (other rows are not written).
extern "C" int ecamp_fused_ce_fwd_tiles(const void* x, const void* w, const void* b,
                                        const void* labels, void* tile_stats, void* gold, int N,
                                        int V, int D, int tiles, void* stream) {
  if (N <= 0 || V <= 0 || D <= 0 || D % 8 || tiles != (V + tc::kDlBN - 1) / tc::kDlBN)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!bf16_map(&ta, x, N, D, D, tc::kBM) || !bf16_map(&tb, w, V, D, D, tc::kDlBN))
    return (int)cudaErrorInvalidValue;
  tc::Args p = {};
  p.M = N, p.N = V, p.K = D;
  p.bias = static_cast<const float*>(b);
  p.labels = static_cast<const long long*>(labels);
  p.tile_stats = static_cast<float2*>(tile_stats);
  p.gold = static_cast<float*>(gold);
  return launch_tc<tc::kDlBN>(fused_ce_fwd_tiles_kernel, ta, tb, p,
                              static_cast<cudaStream_t>(stream));
}

// Merge: lse (N,) fp32 from the tiles' stats, gold 0 where the label lies
// outside [0, V).
extern "C" int ecamp_fused_ce_fwd_merge(const void* tile_stats, const void* labels, void* lse,
                                        void* gold, int N, int V, int tiles, void* stream) {
  if (N <= 0 || V <= 0 || tiles != (V + tc::kDlBN - 1) / tc::kDlBN)
    return (int)cudaErrorInvalidValue;
  fused_ce_fwd_merge_kernel<<<(N + kMergeRows - 1) / kMergeRows, kMergeRows * kMergeGroups, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(tile_stats), static_cast<const long long*>(labels),
      static_cast<float*>(lse), static_cast<float*>(gold), N, V, tiles);
  return (int)cudaGetLastError();
}

// As the forward, plus lse and wg (= weights * upstream gradient) (N,)
// fp32 inputs; dx (N, D) output in x's dtype.
extern "C" int ecamp_fused_ce_bwd_dx(const void* x, const void* w, const void* b,
                                     const void* labels, const void* lse, const void* wg,
                                     void* dx, int N, int V, int D, int dtype, void* stream) {
  return dispatch_bwd<false>(x, w, b, labels, lse, wg, dx, nullptr, N, V, D, dtype,
                             static_cast<cudaStream_t>(stream));
}

// As dx, with outputs dW (V, D) in w's dtype (= x's) and db (V,) fp32.
extern "C" int ecamp_fused_ce_bwd_dw(const void* x, const void* w, const void* b,
                                     const void* labels, const void* lse, const void* wg,
                                     void* dw, void* db, int N, int V, int D, int dtype,
                                     void* stream) {
  return dispatch_bwd<true>(x, w, b, labels, lse, wg, dw, db, N, V, D, dtype,
                            static_cast<cudaStream_t>(stream));
}

// ---------------------------------------------------------------------------
// the tensor-core backward, one chunk of vocab rows [v0, v0 + width) a call.
// bf16, D % 8 == 0, 16-byte aligned bases; the scratch dl' (N, ld) and the
// partials (ceil(N / 128), ld) have ld >= width, ld % 8 == 0.

// dl' of the chunk and its partial column sums. x (N, D), w (V, D), b (V,)
// fp32, labels (N,) int64, lse and wg (N,) fp32.
extern "C" int ecamp_fused_ce_bwd_dl(const void* x, const void* w, const void* b,
                                     const void* labels, const void* lse, const void* wg,
                                     void* dl, void* partials, int N, int V, int D, int v0,
                                     int width, int ld, void* stream) {
  if (!chunk_ok(N, V, D, v0, width, ld)) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!bf16_map(&ta, x, N, D, D, tc::kBM) || !bf16_map(&tb, w, V, D, D, tc::kDlBN))
    return (int)cudaErrorInvalidValue;
  tc::Args p = {};
  p.M = N, p.N = width, p.K = D, p.b_row0 = v0, p.v0 = v0, p.ld = ld;
  p.bias = static_cast<const float*>(b);
  p.labels = static_cast<const long long*>(labels);
  p.lse = static_cast<const float*>(lse);
  p.wg = static_cast<const float*>(wg);
  p.dl = static_cast<bf16*>(dl);
  p.partials = static_cast<float*>(partials);
  return launch_tc<tc::kDlBN>(fused_ce_bwd_dl_kernel, ta, tb, p, static_cast<cudaStream_t>(stream));
}

// dx32 (N, D) fp32 (+)= dl'_c w_c; with `last`, dx (N, D) bf16 instead
// (`first` and `last`: dx32 is not read or written).
extern "C" int ecamp_fused_ce_bwd_dx_chunk(const void* dl, const void* w, void* dx32, void* dx,
                                           int N, int V, int D, int v0, int width, int ld,
                                           int first, int last, void* stream) {
  if (!chunk_ok(N, V, D, v0, width, ld)) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!bf16_map(&ta, dl, N, width, ld, tc::kBM) || !bf16_map(&tb, w, V, D, D, tc::kBK))
    return (int)cudaErrorInvalidValue;
  tc::Args p = {};
  p.M = N, p.N = D, p.K = width, p.b_row0 = v0, p.v0 = v0, p.ld = ld;
  p.acc32 = static_cast<float*>(dx32);
  p.out = static_cast<bf16*>(dx);
  p.first = first, p.last = last;
  return launch_tc<192>(fused_ce_bwd_dx_kernel, ta, tb, p, static_cast<cudaStream_t>(stream));
}

// dW rows [v0, v0 + width) of dW (V, D) bf16 = dl'_c^T x, and db (V,) fp32
// of those rows from the partials.
extern "C" int ecamp_fused_ce_bwd_dw_chunk(const void* dl, const void* x, const void* partials,
                                           void* dw, void* db, int N, int V, int D, int v0,
                                           int width, int ld, void* stream) {
  if (!chunk_ok(N, V, D, v0, width, ld)) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!bf16_map(&ta, dl, N, width, ld, tc::kBK) || !bf16_map(&tb, x, N, D, D, tc::kBK))
    return (int)cudaErrorInvalidValue;
  tc::Args p = {};
  p.M = width, p.N = D, p.K = N, p.b_row0 = 0, p.v0 = v0, p.ld = ld;
  p.partials = const_cast<float*>(static_cast<const float*>(partials));
  p.n_mtiles = (N + tc::kBM - 1) / tc::kBM;
  p.out = static_cast<bf16*>(dw);
  p.db = static_cast<float*>(db);
  return launch_tc<192>(fused_ce_bwd_dw_kernel, ta, tb, p, static_cast<cudaStream_t>(stream));
}

// c (M, N) fp32 = the mainloop's product of bf16 a and b in one layout:
// 0: a (M, K), b (N, K), c = a b^T; 1: a (M, K), b (K, N), c = a b;
// 2: a (K, M), b (K, N), c = a^T b. Contiguous; K and N multiples of 8 (and
// M for layout 2).
extern "C" int ecamp_wgmma_gemm(const void* a, const void* b, void* c, int M, int N, int K,
                                int layout, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  tc::Args p = {};
  p.M = M, p.N = N, p.K = K;
  p.c = static_cast<float*>(c);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (layout == 0) {
    if (!bf16_map(&ta, a, M, K, K, tc::kBM) || !bf16_map(&tb, b, N, K, K, tc::kDlBN))
      return (int)cudaErrorInvalidValue;
    return launch_tc<tc::kDlBN>(wgmma_gemm_kernel<0>, ta, tb, p, s);
  }
  if (layout == 1) {
    if (!bf16_map(&ta, a, M, K, K, tc::kBM) || !bf16_map(&tb, b, K, N, N, tc::kBK))
      return (int)cudaErrorInvalidValue;
    return launch_tc<192>(wgmma_gemm_kernel<1>, ta, tb, p, s);
  }
  if (layout == 2) {
    if (!bf16_map(&ta, a, K, M, M, tc::kBK) || !bf16_map(&tb, b, K, N, N, tc::kBK))
      return (int)cudaErrorInvalidValue;
    return launch_tc<192>(wgmma_gemm_kernel<2>, ta, tb, p, s);
  }
  return (int)cudaErrorInvalidValue;
}
