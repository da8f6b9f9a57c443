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
// Forward: a block owns kOwn = 32 rows of x and streams the vocab in tiles
// of kStr = 128 rows; each 32 x 128 logit tile is computed over D in
// shared-memory stages (bf16 with D % 8 == 0: mma.sync m16n8k16 on
// double-buffered cp.async stages; else the FMA pipe) and folded into a
// running (max, sum-exp, gold) per row. The logits never reach device
// memory.
//
// Backward, bf16 with D % 8 == 0 and 16-byte aligned bases (the wrapper's
// shape rule): the vocabulary in chunks of Vc rows, three kernels a chunk,
// each one GEMM of one mainloop (tc::gemm_body: TMA loads into a ring of
// 128-byte-swizzled tiles behind mbarriers, one producer thread, two
// consumer warpgroups running wgmma on 128 x BN tiles, a persistent grid)
// with its own epilogue:
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
// fp32, and bf16 of other widths or alignments, run the FMA backward: a
// block owns 32 rows of one operand (x for dx, w for dW + db), recomputes
// each 32 x 128 logit tile against the streamed operand and accumulates
// its (32 x D) output in registers.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kOwn = 32;       // owned rows a block
constexpr int kStr = 128;      // streamed rows a tile
constexpr int kDMax = 768;     // widest D the register accumulators hold
constexpr int kPad = 4;        // fp32 rows: keeps 16 bytes, spreads banks
// FMA path
constexpr int kBK = 32;        // depth of one logit-tile stage
constexpr int kBK2 = 8;        // streamed rows of one accumulation stage
constexpr int kNJ = kDMax / 128;
// tensor-core path
constexpr int kBKm = 64;       // depth of one logit-tile stage
constexpr int kPadH = 8;       // bf16 rows: 16-byte ldmatrix rows, no conflicts

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

struct MmaTile {  // tensor cores: one stage of the logit tile, row-major bf16
  bf16 own[kOwn][kBKm + kPadH];
  bf16 str[kStr][kBKm + kPadH];
};

struct MmaSmem {
  union {  // each is handed on only after a block-wide barrier
    MmaTile tile[2];             // double-buffered: one fills while one is read
    float s[kOwn][kStr + kPad];  // the fp32 logit tile, for the epilogue
  } st;
};

// the forward takes its stages as dynamic shared memory of this type
template <bool kMma>
using FwdSmem = typename std::conditional<kMma, MmaSmem, TileStage>::type;

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
// the 32 x 128 logit tile, tensor cores

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d (16 x 8, fp32) += a (16 x 16, row-major bf16) * b (16 x 8, col-major
// bf16); d0, d1 are row lane/4, columns 2 (lane%4) + {0, 1}; d2, d3 the
// same columns of row lane/4 + 8
__device__ __forceinline__ void mma_bf16(float& d0, float& d1, float& d2, float& d3,
                                         const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d0), "+f"(d1), "+f"(d2), "+f"(d3)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes from device memory into shared memory without the registers,
// asynchronously (cp.async, L2 only); where !ok, zeros and no read (src is
// then `base`, a valid address)
__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src, const bf16* base,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(ok ? src : base), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// A fragment of rows m0..m0+15, k0..k0+15 of a row-major [m][k] array
template <int kLd>
__device__ __forceinline__ void frag_a(bf16 (*a)[kLd], int m0, int k0, unsigned (&r)[4]) {
  const int lane = threadIdx.x % 32;
  ldsm_x4(&a[m0 + ((lane / 8) % 2) * 8 + lane % 8][k0 + (lane / 16) * 8], r);
}

// logit_tile's result through bf16 tensor cores: warp w computes rows
// 16 (w % 2).. and columns 32 (w / 2).. of the tile, the fp32 tile goes
// through shared memory into the epilogue's layout. The kBKm-deep stages
// are double-buffered: stage k + 1 is in flight while stage k is read.
// D % 8 == 0.
__device__ __forceinline__ void mma_logit_tile(const bf16* __restrict__ own, long long o0,
                                               int n_own, const bf16* __restrict__ str,
                                               long long t0, int n_str, int D, MmaSmem& sm,
                                               float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wo = warp % 2, wt = warp / 2;
  float c[4][4] = {};  // n-block nb of the warp's 16 x 32: its C fragment
  constexpr int kChunks = kBKm / 8;  // 16-byte chunks a row of a stage
  auto fill = [&](MmaTile& s, int k0) {
    for (int e = tid; e < (kOwn + kStr) * kChunks; e += kThreads) {
      const int r = e / kChunks, kc = (e % kChunks) * 8;
      if (r < kOwn) {
        cp_async16(&s.own[r][kc], own + (o0 + r) * D + k0 + kc, own,
                   o0 + r < n_own && k0 + kc < D);
      } else {
        const int q = r - kOwn;
        cp_async16(&s.str[q][kc], str + (t0 + q) * D + k0 + kc, str,
                   t0 + q < n_str && k0 + kc < D);
      }
    }
    cp_async_commit();
  };
  const int nk = (D + kBKm - 1) / kBKm;
  __syncthreads();  // the stages' previous readers are done
  fill(sm.st.tile[0], 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      fill(sm.st.tile[(kc + 1) % 2], (kc + 1) * kBKm);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage kc has landed for every thread
    MmaTile& s = sm.st.tile[kc % 2];
#pragma unroll
    for (int ks = 0; ks < kBKm; ks += 16) {
      unsigned a[4];
      frag_a(s.own, wo * 16, ks, a);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // B = str^T: rows of str are the columns n; matrices (n, k), (n, k+8),
        // (n+8, k), (n+8, k+8) give b0b1, b2b3 of n-blocks n and n+8
        unsigned b[4];
        ldsm_x4(&s.str[wt * 32 + np * 16 + (lane / 16) * 8 + lane % 8][ks + ((lane / 8) % 2) * 8],
                b);
        const int n = np * 2;
        mma_bf16(c[n][0], c[n][1], c[n][2], c[n][3], a, b[0], b[1]);
        mma_bf16(c[n + 1][0], c[n + 1][1], c[n + 1][2], c[n + 1][3], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with the stage before it refills
  }
  const int g = lane / 4, q = lane % 4;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int col = wt * 32 + nb * 8 + q * 2;
    sm.st.s[wo * 16 + g][col] = c[nb][0];
    sm.st.s[wo * 16 + g][col + 1] = c[nb][1];
    sm.st.s[wo * 16 + g + 8][col] = c[nb][2];
    sm.st.s[wo * 16 + g + 8][col + 1] = c[nb][3];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 v = *reinterpret_cast<const float4*>(&sm.st.s[warp * 4 + i][lane * 4]);
    acc[i][0] = v.x;
    acc[i][1] = v.y;
    acc[i][2] = v.z;
    acc[i][3] = v.w;
  }
}

// ---------------------------------------------------------------------------
// epilogues shared by both paths (the (ty, tx) 4 x 4 layout)

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
template <typename T, bool kMma>
__global__ void __launch_bounds__(kThreads, 2)
fused_ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, const long long* __restrict__ labels,
                    float* __restrict__ lse, float* __restrict__ gold, int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  FwdSmem<kMma>& s = *reinterpret_cast<FwdSmem<kMma>*>(smem);
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
    if constexpr (kMma)
      mma_logit_tile(x, r0, N, w, v0, V, D, s, acc);
    else
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

// the tensor-core path: bf16, whole 16-byte row chunks, aligned bases
bool use_mma(int dtype, int D, const void* x, const void* w, const void* out) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  return dtype == 1 && D % 8 == 0 && (bits & 15) == 0;
}

// a launch's dynamic shared memory; above 48 KB only once allowed
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, bool kMma>
int launch_fwd(const void* x, const void* w, const void* b, const void* labels, void* lse,
               void* gold, int N, int V, int D, cudaStream_t stream) {
  const int blocks = (N + kOwn - 1) / kOwn;
  const size_t smem = sizeof(FwdSmem<kMma>);
  const cudaError_t err = allow_smem(fused_ce_fwd_kernel<T, kMma>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_ce_fwd_kernel<T, kMma><<<blocks, kThreads, smem, stream>>>(
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
// the tensor-core backward: TMA + wgmma GEMMs over vocab chunks

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

enum Epi { kEpiDl, kEpiDx, kEpiDw, kEpiGemm };

// What the epilogues read. C is M x N over K; B's map starts at row b_row0.
struct Args {
  int M, N, K, b_row0;
  int v0, ld;                    // chunk start in V; row stride of dl' and partials
  const float* bias;             // dl: fp32 (V,)
  const long long* labels;       // dl: (N,)
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// one 2-D box of the map at (c0 = column, c1 = row) into shared memory;
// the barrier counts its bytes (out-of-bounds elements arrive as zeros)
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1 (SW128)
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo, unsigned sbo) {
  const unsigned a = smem_addr(p);
  return (uint64_t)((a & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's fence and wait
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the two consumer warpgroups' own barrier (the producer never joins)
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }

// d (64 x 128, fp32, the warpgroup's accumulator fragments) += A B of one
// 16-deep step, A and B read from shared memory through their descriptors;
// kTA / kTB: 0 = K-major, 1 = MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

// d (64 x 192, fp32, the warpgroup's accumulator fragments) += A B of one
// 16-deep step, A and B read from shared memory through their descriptors;
// kTA / kTB: 0 = K-major, 1 = MN-major
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      " %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "%96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(kTA), "n"(kTB));
}

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
  const int tiles_n = (p.N + BN - 1) / BN;
  const int tiles = (p.M + kBM - 1) / kBM * tiles_n;
  const int nk = (p.K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wgi == 2) {  // producer
    if constexpr (kCtasOf<BN> == 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int s = 0;
      unsigned ph = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * BN;
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
      const int m0 = t / tiles_n * kBM, n0 = t % tiles_n * BN;
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
      if constexpr (kEpi == kEpiDl)
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

// host side: tensor maps by cuTensorMapEncodeTiled, fetched at run time (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  return fn;
}

// a bf16 (rows, cols) matrix with row stride ld elements, read in boxes of
// box_rows x 64, 128-byte swizzled; out-of-bounds boxes fill with zeros
bool bf16_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const EncodeTiledFn enc = encode_fn();
  if (enc == nullptr || (reinterpret_cast<uintptr_t>(base) & 15) || ld % 8) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return n;
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

// x (N, D), w (V, D): contiguous, of `dtype` (0 = fp32, 1 = bf16); b (V,)
// fp32; labels (N,) int64; lse, gold (N,) fp32 outputs. D <= 768.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ecamp_fused_ce_fwd(const void* x, const void* w, const void* b,
                                  const void* labels, void* lse, void* gold, int N, int V,
                                  int D, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bad_shape(N, V, D)) return (int)cudaErrorInvalidValue;
  if (use_mma(dtype, D, x, w, x))
    return launch_fwd<bf16, true>(x, w, b, labels, lse, gold, N, V, D, s);
  if (dtype == 1) return launch_fwd<bf16, false>(x, w, b, labels, lse, gold, N, V, D, s);
  if (dtype == 0) return launch_fwd<float, false>(x, w, b, labels, lse, gold, N, V, D, s);
  return (int)cudaErrorInvalidValue;
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
