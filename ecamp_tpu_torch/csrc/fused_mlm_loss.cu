// Fused vocab projection + weighted cross-entropy for Hopper (sm_90a),
// plain C interface: a forward kernel and two backward kernels (dx, dW/db).
//
// Replaces the TPU kernels of ecamp_tpu/kernels/fused_mlm_loss.py:
//   _fwd_kernel (launched by _fused_fwd):      lse, gold per row
//   _bwd_dx_kernel, _bwd_dw_kernel (launched by _fused_bwd_impl)
// over x (N, D), the decoder weight w (V, D) row-major (the port's Linear
// layout: both operands of x w^T are contiguous along D, so no transpose is
// made), the fp32 bias b (V,) and labels (N,):
//   logits = x w^T + b (fp32), never stored in device memory
//   fwd:  lse = logsumexp(logits), gold = logits[label]        (fp32)
//   bwd:  dl = (softmax(logits) - onehot(label)) * wg   (wg = weights * g)
//         dx = dl' w,  dW = dl'^T x  with dl' = dl rounded to x's dtype,
//         db = colsum(dl) in fp32.
//
// What bounds it on the H100: at the pretraining shape (N = 8192, D = 768,
// V = 30000) the forward is 2NDV = 0.38 TFLOP and each backward kernel
// recomputes its logit tiles, 0.75 TFLOP each, on 59 MB of operands: far
// above the ridge point, so it is compute-bound, and what it saves is the
// (N, V) logits and their CE intermediates in device memory.
// What the design does about it: every kernel is a tile GEMM over shared
// memory. A block owns kOwn = 32 rows of one operand and streams the other
// in tiles of kStr = 128 rows; each 32 x 128 logit tile is computed over D
// in shared-memory stages and handed to the epilogue in one layout (warp
// `ty` holds rows 4 ty..4 ty+3, lane `tx` columns 4 tx..4 tx+3). The
// forward folds each tile into a running (max, sum-exp, gold) of its rows.
// The backward kernels turn the tile into dl' in shared memory and
// accumulate the owned rows' (32 x D) output in registers (96 a thread at
// D = 768) from the streamed rows, so no reduction crosses blocks and
// nothing is atomic:
//   dx:  owned = rows of x,             streamed = vocab rows of w
//   dW:  owned = vocab rows of w (+db), streamed = rows of x.
// Two ways through the two products:
//   * bf16 with D % 8 == 0 and 16-byte aligned rows: tensor cores,
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate) on ldmatrix fragments;
//     the operands go into double-buffered shared-memory stages with
//     cp.async, 16 bytes at a time, in their row-major layout (the dW/dx
//     product reads its streamed operand transposed with ldmatrix.trans);
//   * otherwise (fp32, odd widths): the FMA pipe, 4 x 4 products a thread
//     from k-major fp32 stages.
// Ragged N, V and D are masked by bounds (no padding copies); a row or
// column outside the bounds contributes dl = 0, so a padded row's
// exp(logit - lse) never reaches dx, dW or db.

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
constexpr int kBK2m = 16;      // streamed rows of one accumulation stage
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

struct MmaAcc {  // tensor cores: kBK2m streamed rows, the whole of D
  bf16 str[kBK2m][kDMax + kPadH];
};

struct MmaSmem {
  union {  // each is handed on only after a block-wide barrier
    MmaTile tile[2];             // double-buffered: one fills while one is read
    float s[kOwn][kStr + kPad];  // the fp32 logit tile, for the epilogue
    MmaAcc acc[2];
  } st;
  bf16 dl[kOwn][kStr + kPadH];  // dl' of the tile, [own][str], bf16
};

// every kernel takes its stages as dynamic shared memory of this type
template <bool kMma>
using FwdSmem = typename std::conditional<kMma, MmaSmem, TileStage>::type;
template <bool kMma>
using BwdSmem = typename std::conditional<kMma, MmaSmem, FmaSmem>::type;

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

__device__ __forceinline__ void ldsm_x4_trans(const void* p, unsigned (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
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

// out[own] += dl' . str over kStr streamed rows, tensor cores: warp w owns
// rows 16 (w % 2).. and columns 192 (w / 2).. of the 32 x D output;
// acc[nb * 4 + c] is element c of n-block nb's C fragment. The kBK2m-row
// stages are double-buffered. D % 8 == 0.
__device__ __forceinline__ void mma_accumulate(const bf16* __restrict__ str, int t0, int n_str,
                                               int D, MmaSmem& sm, float (&acc)[kNJ * 16]) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wo = warp % 2, wd = warp / 2;
  const int dchunks = (D + 15) / 16 * 2;  // zero-filled to whole n-block pairs
  auto fill = [&](MmaAcc& s, int k0) {
    for (int e = threadIdx.x; e < kBK2m * dchunks; e += kThreads) {
      const int r = e / dchunks, dc = (e % dchunks) * 8;
      const long long t = (long long)t0 + k0 + r;
      cp_async16(&s.str[r][dc], str + t * D + dc, str, t < n_str && dc < D);
    }
    cp_async_commit();
  };
  constexpr int nk = kStr / kBK2m;
  __syncthreads();  // the dl tile is stored; the stages' readers are done
  fill(sm.st.acc[0], 0);
  for (int kc = 0; kc < nk; ++kc) {
    if (kc + 1 < nk) {
      fill(sm.st.acc[(kc + 1) % 2], (kc + 1) * kBK2m);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage kc has landed for every thread
    MmaAcc& s = sm.st.acc[kc % 2];
    unsigned a[4];
    frag_a(sm.dl, wo * 16, kc * kBK2m, a);
#pragma unroll
    for (int np = 0; np < 12; ++np) {
      const int n0 = wd * 192 + np * 16;
      if (n0 >= D) break;
      // B = str[k][n], n contiguous: transposed matrices (k, n), (k+8, n),
      // (k, n+8), (k+8, n+8) give b0b1, b2b3 of n-blocks n and n+8
      unsigned bb[4];
      ldsm_x4_trans(&s.str[((lane / 8) % 2) * 8 + lane % 8][n0 + (lane / 16) * 8], bb);
      const int c = np * 8;  // n-blocks 2 np and 2 np + 1
      mma_bf16(acc[c], acc[c + 1], acc[c + 2], acc[c + 3], a, bb[0], bb[1]);
      mma_bf16(acc[c + 4], acc[c + 5], acc[c + 6], acc[c + 7], a, bb[2], bb[3]);
    }
    __syncthreads();  // every warp is done with the stage before it refills
  }
}

__device__ __forceinline__ void mma_store(const float (&acc)[kNJ * 16], long long o0, int n_own,
                                          int D, bf16* __restrict__ out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int wo = warp % 2, wd = warp / 2;
  const long long row = o0 + wo * 16 + lane / 4;
#pragma unroll
  for (int nb = 0; nb < 24; ++nb) {
    const int d = wd * 192 + nb * 8 + (lane % 4) * 2;
    if (d >= D) break;
    if (row < n_own)
      *reinterpret_cast<__nv_bfloat162*>(&out[row * D + d]) =
          __floats2bfloat162_rn(acc[nb * 4], acc[nb * 4 + 1]);
    if (row + 8 < n_own)
      *reinterpret_cast<__nv_bfloat162*>(&out[(row + 8) * D + d]) =
          __floats2bfloat162_rn(acc[nb * 4 + 2], acc[nb * 4 + 3]);
  }
}

// dx (kVocabOwned = false) or dW + db (true). A block owns 32 rows of one
// operand and streams the other; for each streamed tile it recomputes the
// 32 x 128 logits, forms dl, and accumulates out[own] += dl' . str.
template <typename T, bool kVocabOwned, bool kMma>
__global__ void __launch_bounds__(kThreads, 1)
fused_ce_bwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const float* __restrict__ b, const long long* __restrict__ labels,
                    const float* __restrict__ lse, const float* __restrict__ wg,
                    T* __restrict__ out, float* __restrict__ db, int N, int V, int D) {
  extern __shared__ __align__(16) unsigned char smem[];
  BwdSmem<kMma>& sm = *reinterpret_cast<BwdSmem<kMma>*>(smem);
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
    if constexpr (kMma)
      mma_logit_tile(own, o0, n_own, str, t0, n_str, D, sm, z);
    else
      logit_tile(own, o0, n_own, str, t0, n_str, D, sm.st.tile, z);
    tile_dl<kVocabOwned>(z, o0, t0, N, V, b, labels, lse, wg, dl, dbsum);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (kMma) {  // dx and dW take dl in x's dtype
        __nv_bfloat162 lo = __floats2bfloat162_rn(dl[i][0], dl[i][1]);
        __nv_bfloat162 hi = __floats2bfloat162_rn(dl[i][2], dl[i][3]);
        uint2 v;
        v.x = *reinterpret_cast<unsigned*>(&lo);
        v.y = *reinterpret_cast<unsigned*>(&hi);
        *reinterpret_cast<uint2*>(&sm.dl[ty * 4 + i][tx * 4]) = v;
      } else {
        *reinterpret_cast<float4*>(&sm.dl[ty * 4 + i][tx * 4]) =
            make_float4(to_f(from_f<T>(dl[i][0])), to_f(from_f<T>(dl[i][1])),
                        to_f(from_f<T>(dl[i][2])), to_f(from_f<T>(dl[i][3])));
      }
    }
    if constexpr (kMma) {
      mma_accumulate(str, t0, n_str, D, sm, acc);
    } else {
      fma_accumulate(str, t0, n_str, D, sm, acc);
    }
  }

  if (kVocabOwned) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float s = warp_sum(dbsum[i]);
      const long long o = o0 + ty * 4 + i;
      if (tx == 0 && o < n_own) db[o] = s;
    }
  }
  if constexpr (kMma)
    mma_store(acc, o0, n_own, D, out);
  else
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

template <typename T, bool kVocabOwned, bool kMma>
int launch_bwd(const void* x, const void* w, const void* b, const void* labels,
               const void* lse, const void* wg, void* out, void* db, int N, int V, int D,
               cudaStream_t stream) {
  const int blocks = ((kVocabOwned ? V : N) + kOwn - 1) / kOwn;
  const size_t smem = sizeof(BwdSmem<kMma>);
  const cudaError_t err = allow_smem(fused_ce_bwd_kernel<T, kVocabOwned, kMma>, smem);
  if (err != cudaSuccess) return (int)err;
  fused_ce_bwd_kernel<T, kVocabOwned, kMma><<<blocks, kThreads, smem, stream>>>(
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
  if (use_mma(dtype, D, x, w, out))
    return launch_bwd<bf16, kVocabOwned, true>(x, w, b, labels, lse, wg, out, db, N, V, D, s);
  if (dtype == 1)
    return launch_bwd<bf16, kVocabOwned, false>(x, w, b, labels, lse, wg, out, db, N, V, D, s);
  if (dtype == 0)
    return launch_bwd<float, kVocabOwned, false>(x, w, b, labels, lse, wg, out, db, N, V, D, s);
  return (int)cudaErrorInvalidValue;
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
