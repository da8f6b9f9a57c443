// Fused softmax attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/flash_attention.py::_attn_kernel
// (launched by _flash_attention_impl): per batch*head,
// softmax(Q K^T * scale + bias) V with fp32 logits and softmax, the
// probabilities rounded to the input dtype before the PV product, and the
// division by the softmax denominator taken once, after PV, in fp32.
//
// What bounds it on the H100: a (batch*head) reads q, k, v and writes o,
// 2 (Nq + Nk) D elements, and does 4 Nq Nk D flops. In bf16 that is about
// N / 2 flops a byte at Nq = Nk = N: below the card's ridge point (989
// TFLOP/s over 3.35 TB/s, about 295 flops a byte) at every shape of the
// pretraining step and of 224-px serving (N <= 256: 13 to 128 flops a
// byte), so device-memory bytes bound those; at N = 785 (448-px serving)
// it is about 390, so the tensor cores bound it.
// What the design does about it:
//   * bf16 (the model's compute dtype): a FlashAttention-2 style kernel on
//     the tensor cores, mma.sync m16n8k16 (bf16 in, fp32 accumulate). One
//     block of 4 warps per (batch*head, 64-query tile); each warp owns 16
//     query rows. The Q tile arrives by cp.async and stays in registers as
//     ldmatrix A fragments for the whole key loop. K and V arrive in
//     64-key tiles, double-buffered in shared memory by cp.async, so tile
//     t + 1 is in flight while tile t is used; rows are padded by 16 bytes
//     so ldmatrix reads hit distinct banks, and V's B fragments come from
//     ldmatrix.trans. S = Q K^T (16 x 64 a warp, fp32) takes the scale, the
//     bias and the bounds mask, the online softmax keeps each row's
//     running max and denominator in registers (reduced over the 4 lanes
//     of a row by shuffles), and P is converted from S's accumulator
//     layout straight into bf16 A fragments for O += P V, with no trip
//     through shared memory. So q, k, v are read once from device memory
//     (K and V once a 64-query tile, from L2 after the first), the logits
//     never leave the SM, and o is written once, as 16-byte rows staged
//     through shared memory. For the memory-bound shapes what matters is
//     bytes moved once with enough blocks in flight (768 blocks at the
//     BERT shape); for N = 785 the products run on the tensor cores.
//   * fp32 (and bf16 whose pointers are not 16-byte aligned): the FMA pipe,
//     one block per (batch*head, 64-query tile), four threads per query
//     row, K/V tiles staged in shared memory. TF32 would miss the fp32
//     tolerance; no model path runs it.
// Ragged Nq / Nk edges are masked by bounds (zero-filled loads, -inf
// logits past Nk), with no padding copies. The optional fp32 bias is read
// through four element strides (0 on a broadcast dim), which covers the
// (B,1,1,Nk) key-padding and the full (B,H,Nq,Nk) layouts; a bias that
// does not vary over the query rows is staged once a key tile in shared
// memory. A row whose logits so far are all -inf keeps its exponents
// finite (the BERT mask is finfo(fp32).min, not -inf).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// ---------------------------------------------------------------------------
// FMA pipe (fp32)

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kSplit = 4;  // threads per query row
constexpr int kThreads = kQTile * kSplit;

// Grid: x = batch*head, y = 64-query tiles. Block: 256 threads, four per
// query row; thread `part` of a row owns the columns part, part+4, ...
// (neighbouring threads read neighbouring shared-memory words).
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const float* __restrict__ bias,
                     long long sb_b, long long sb_h, long long sb_q, long long sb_k,
                     T* __restrict__ o, int H, int Nq, int Nk, float scale) {
  constexpr int DS = D / kSplit;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);
  T* vs = ks + kKTile * D;

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int part = tid % kSplit;
  const int qi = blockIdx.y * kQTile + tid / kSplit;
  const bool row_ok = qi < Nq;

  const T* qb = q + (long long)bh * Nq * D;
  const T* kb = k + (long long)bh * Nk * D;
  const T* vb = v + (long long)bh * Nk * D;
  const float* brow = nullptr;
  if (bias != nullptr) {
    brow = bias + (long long)(bh / H) * sb_b + (long long)(bh % H) * sb_h +
           (long long)(row_ok ? qi : 0) * sb_q;
  }

  float qr[DS], acc[DS];
#pragma unroll
  for (int c = 0; c < DS; ++c) {
    qr[c] = row_ok ? to_f(qb[(long long)qi * D + c * kSplit + part]) : 0.f;
    acc[c] = 0.f;
  }
  float m = -CUDART_INF_F;  // running max of this row's logits
  float l = 0.f;            // running softmax denominator

  for (int k0 = 0; k0 < Nk; k0 += kKTile) {
    __syncthreads();  // every thread is done with the previous tile
    for (int idx = tid; idx < kKTile * D; idx += kThreads) {
      const int kj = k0 + idx / D;
      const long long off = (long long)kj * D + idx % D;
      ks[idx] = kj < Nk ? kb[off] : from_f<T>(0.f);
      vs[idx] = kj < Nk ? vb[off] : from_f<T>(0.f);
    }
    __syncthreads();

    float s[kKTile];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      float d = 0.f;
#pragma unroll
      for (int c = 0; c < DS; ++c) d = fmaf(qr[c], to_f(ks[j * D + c * kSplit + part]), d);
      // the four threads of a row are neighbouring lanes of one warp
      d += __shfl_xor_sync(0xffffffffu, d, 1);
      d += __shfl_xor_sync(0xffffffffu, d, 2);
      float x = d * scale;
      const int kj = k0 + j;
      if (kj < Nk) {
        if (brow != nullptr) x += brow[(long long)kj * sb_k];
      } else {
        x = -CUDART_INF_F;
      }
      s[j] = x;
      tile_max = fmaxf(tile_max, x);
    }

    const float m_new = fmaxf(m, tile_max);
    // a row whose logits so far are all -inf keeps exponents finite
    const float m_use = m_new == -CUDART_INF_F ? 0.f : m_new;
    const float alpha = expf(m - m_use);
    l *= alpha;
#pragma unroll
    for (int c = 0; c < DS; ++c) acc[c] *= alpha;
#pragma unroll
    for (int j = 0; j < kKTile; ++j) {
      const float p = expf(s[j] - m_use);
      l += p;
      const float pv = to_f(from_f<T>(p));  // Pallas: p.astype(v.dtype)
#pragma unroll
      for (int c = 0; c < DS; ++c) acc[c] = fmaf(pv, to_f(vs[j * D + c * kSplit + part]), acc[c]);
    }
    m = m_new;
  }

  if (row_ok) {
    T* orow = o + ((long long)bh * Nq + qi) * D;
#pragma unroll
    for (int c = 0; c < DS; ++c) orow[c * kSplit + part] = from_f<T>(acc[c] / l);
  }
}

// ---------------------------------------------------------------------------
// tensor cores (bf16)

constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMQ = 16 * kMmaWarps;  // query rows a block, 16 a warp
constexpr int kMK = 64;              // keys a tile
constexpr int kPadH = 8;             // bf16 row padding: 16 bytes, ldmatrix rows on distinct banks
constexpr float kLog2e = 1.4426950408889634f;

// the bias a launch takes: none, one that does not vary over the query
// rows (the key-padding mask, staged a key tile at a time in shared
// memory), or any other, read through its strides
enum BiasKind { kNoBias = 0, kKeyBias = 1, kFullBias = 2 };

template <int D>
struct MmaSmem {
  bf16 q[kMQ][D + kPadH];     // the Q tile; at the end each warp's output rows
  bf16 k[2][kMK][D + kPadH];  // double-buffered key tiles
  bf16 v[2][kMK][D + kPadH];  // and value tiles
  float bias[2][kMK];         // a kKeyBias bias's values for the tile
};

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
// bf16); d[0], d[1] are row lane/4, columns 2 (lane%4) + {0, 1}; d[2], d[3]
// the same columns of row lane/4 + 8
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 (or 4) bytes from device memory into shared memory without the
// registers, asynchronously; where !ok, zeros and no read (src is then
// `base`, a valid address)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, const void* base, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(ok ? src : base), "r"(ok ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, const void* base, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(ok ? src : base), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// 2^x on the special-function unit (relative error about 2^-22; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<unsigned*>(&v);
}

// One block of 4 warps per (batch*head, 64-query tile), numbered with the
// query tiles of a batch*head next to each other, so they run together and
// share its K and V in L2. Warp w owns query rows 16 w..16 w+15 of the
// tile; a lane holds rows g = lane/4 and g + 8 of them.
//
// The logits S' are S * scale + bias, or without a bias S itself with the
// scale folded into f = scale * log2(e), so that p = 2^((S' - m) f) is one
// FMA and one ex2 an element, as in FlashAttention-2. With a bias the
// difference is taken first: a finfo.min mask times log2(e) would
// overflow. Only the last key tile, when Nk is ragged, takes the bounds
// mask.
template <int D, int kBias>
__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const float* __restrict__ bias,
                         long long sb_b, long long sb_h, long long sb_q, long long sb_k,
                         bf16* __restrict__ o, int H, int Nq, int Nk, float scale) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  constexpr int kKD = D / 16;     // k-steps of Q K^T
  constexpr int kNB = kMK / 8;    // n-blocks of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  MmaSmem<D>& sm = *reinterpret_cast<MmaSmem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_qt = (Nq + kMQ - 1) / kMQ;
  const int bh = blockIdx.x / n_qt;
  const int q0 = (blockIdx.x % n_qt) * kMQ;
  const bf16* qb = q + (long long)bh * Nq * D;
  const bf16* kb = k + (long long)bh * Nk * D;
  const bf16* vb = v + (long long)bh * Nk * D;
  const float f = kBias == kNoBias ? scale * kLog2e : kLog2e;
  const float* bb = nullptr;
  const float* brow[2] = {nullptr, nullptr};  // rows g, g + 8, clamped inside Nq
  if (kBias != kNoBias) {
    bb = bias + (long long)(bh / H) * sb_b + (long long)(bh % H) * sb_h;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      brow[r] = bb + (long long)min(q0 + warp * 16 + g + 8 * r, Nq - 1) * sb_q;
  }

  // key tile k0.. into buffer buf (zeros past Nk), then one commit
  auto load_kv = [&](int buf, int k0) {
    for (int e = tid; e < kMK * kChunks; e += kMmaThreads) {
      const int r = e / kChunks, c = (e % kChunks) * 8;
      const bool ok = k0 + r < Nk;
      const long long off = (long long)(k0 + r) * D + c;
      cp_async16(&sm.k[buf][r][c], kb + off, kb, ok);
      cp_async16(&sm.v[buf][r][c], vb + off, vb, ok);
    }
    if (kBias == kKeyBias && tid < kMK)
      cp_async4(&sm.bias[buf][tid], bb + (long long)(k0 + tid) * sb_k, bb, k0 + tid < Nk);
    cp_async_commit();
  };

  // the Q tile and key tile 0 form the first group
  for (int e = tid; e < kMQ * kChunks; e += kMmaThreads) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    cp_async16(&sm.q[r][c], qb + (long long)(q0 + r) * D + c, qb, q0 + r < Nq);
  }
  load_kv(0, 0);

  unsigned qf[kKD][4];  // the warp's 16 query rows as A fragments
  float acc[D / 8][4];  // O: n-block nb's C fragment
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.f;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};  // running max of S', rows g and g + 8
  float l[2] = {0.f, 0.f};  // running denominator, this lane's columns only

  const int nt = (Nk + kMK - 1) / kMK;
  for (int t = 0; t < nt; ++t) {
    if (t + 1 < nt) {
      load_kv((t + 1) % 2, (t + 1) * kMK);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and at t = 0 the Q tile) has landed for every thread
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < kKD; ++kk)
        ldsm_x4(&sm.q[warp * 16 + ((lane / 8) % 2) * 8 + lane % 8][kk * 16 + (lane / 16) * 8],
                qf[kk]);
    }
    const int buf = t % 2, k0 = t * kMK;

    // S = Q K^T: K's rows are the columns n; matrices (n, k), (n, k+8),
    // (n+8, k), (n+8, k+8) give b0 b1 of n-block n and b0 b1 of n + 8
    float s[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nb][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
#pragma unroll
      for (int np = 0; np < kNB / 2; ++np) {
        unsigned b[4];
        ldsm_x4(&sm.k[buf][np * 16 + (lane / 16) * 8 + lane % 8][kk * 16 + ((lane / 8) % 2) * 8],
                b);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // S' (element c of n-block nb is row g + 8 (c / 2), column
    // nb * 8 + 2 t4 + c % 2), then the bounds mask on a ragged last tile
    if (kBias != kNoBias) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = nb * 8 + 2 * t4 + c % 2;
          const float b = kBias == kKeyBias ? sm.bias[buf][col]
                          : k0 + col < Nk  ? brow[c / 2][(long long)(k0 + col) * sb_k]
                                           : 0.f;
          s[nb][c] = fmaf(s[nb][c], scale, b);
        }
    }
    if (k0 + kMK > Nk) {
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + nb * 8 + 2 * t4 + c % 2 >= Nk) s[nb][c] = -CUDART_INF_F;
    }

    // online softmax: the tile's row max over the 4 lanes of a row
    float m_use[2];
    auto p_of = [&](float x, int r) {  // 2^((x - m_use) f)
      return exp2_approx(kBias == kNoBias ? fmaf(x, f, -m_use[r] * f) : (x - m_use[r]) * f);
    };
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) tmax = fmaxf(tmax, fmaxf(s[nb][2 * r], s[nb][2 * r + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[r], tmax);
      // a row whose logits so far are all -inf keeps exponents finite
      m_use[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      const float alpha = p_of(m[r], r);
      l[r] *= alpha;
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb) {
        acc[nb][2 * r] *= alpha;
        acc[nb][2 * r + 1] *= alpha;
      }
      m[r] = m_new;
    }

    // P = 2^((S' - m) f) in fp32 into the denominator, rounded to bf16
    // (Pallas: p.astype(v.dtype)) as A fragments: k-step kk spans n-blocks
    // 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
    unsigned pf[kMK / 16][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb) {
      float p[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) p[c] = p_of(s[nb][c], c / 2);
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pf[nb / 2][(nb % 2) * 2] = pack_bf16(p[0], p[1]);
      pf[nb / 2][(nb % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }

    // O += P V: V is row-major (key, d), read transposed: matrices (k, n),
    // (k+8, n), (k, n+8), (k+8, n+8) give b0 b1 of n-block n and of n + 8
#pragma unroll
    for (int kk = 0; kk < kMK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        unsigned b[4];
        ldsm_x4_trans(
            &sm.v[buf][kk * 16 + ((lane / 8) % 2) * 8 + lane % 8][np * 16 + (lane / 16) * 8], b);
        mma_bf16(acc[2 * np], pf[kk], b[0], b[1]);
        mma_bf16(acc[2 * np + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer `buf` before it refills
  }

  // O / l in fp32, rounded once, through the warp's own rows of sm.q
  // (only this warp read them) to 16-byte stores
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
    const int col = nb * 8 + 2 * t4;
    *reinterpret_cast<unsigned*>(&sm.q[warp * 16 + g][col]) =
        pack_bf16(acc[nb][0] / l[0], acc[nb][1] / l[0]);
    *reinterpret_cast<unsigned*>(&sm.q[warp * 16 + g + 8][col]) =
        pack_bf16(acc[nb][2] / l[1], acc[nb][3] / l[1]);
  }
  __syncwarp();
  bf16* ob = o + (long long)bh * Nq * D;
  for (int e = lane; e < 16 * kChunks; e += 32) {
    const int r = e / kChunks, c = (e % kChunks) * 8;
    const int qi = q0 + warp * 16 + r;
    if (qi < Nq)
      *reinterpret_cast<uint4*>(ob + (long long)qi * D + c) =
          *reinterpret_cast<const uint4*>(&sm.q[warp * 16 + r][c]);
  }
}

// ---------------------------------------------------------------------------
// launches

// a launch's dynamic shared memory; above 48 KB only once allowed
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, const void* bias, long long sb_b,
               long long sb_h, long long sb_q, long long sb_k, void* o, int B, int H, int Nq,
               int Nk, float scale, cudaStream_t stream) {
  const size_t smem = 2 * kKTile * D * sizeof(T);
  auto kernel = attention_fwd_kernel<T, D>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Nq + kQTile - 1) / kQTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), sb_b, sb_h, sb_q, sb_k, static_cast<T*>(o), H, Nq, Nk,
      scale);
  return (int)cudaGetLastError();
}

template <int D, int kBias>
int launch_mma(const void* q, const void* k, const void* v, const void* bias, long long sb_b,
               long long sb_h, long long sb_q, long long sb_k, void* o, int B, int H, int Nq,
               int Nk, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(MmaSmem<D>);
  auto kernel = attention_fwd_mma_kernel<D, kBias>;
  const cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)B * H * ((Nq + kMQ - 1) / kMQ);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  kernel<<<(unsigned)blocks, kMmaThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const float*>(bias), sb_b, sb_h, sb_q, sb_k, static_cast<bf16*>(o), H, Nq,
      Nk, scale);
  return (int)cudaGetLastError();
}

// the tensor-core path: bf16 with 16-byte aligned q, k, v, o (D is a
// multiple of 8, so every row is then aligned too)
bool use_mma(int dtype, const void* q, const void* k, const void* v, const void* o) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return dtype == 1 && (bits & 15) == 0;
}

using Launch = int (*)(const void*, const void*, const void*, const void*, long long, long long,
                       long long, long long, void*, int, int, int, int, float, cudaStream_t);

// the launch for a dtype, head dim, path and bias kind; null for what no
// kernel takes
Launch pick(int dtype, int D, bool mma, int bias_kind) {
  const int i = D == 32 ? 0 : D == 64 ? 1 : D == 128 ? 2 : -1;
  if (i < 0) return nullptr;
  static const Launch kMma[3][3] = {
      {launch_mma<32, kNoBias>, launch_mma<32, kKeyBias>,
       launch_mma<32, kFullBias>},
      {launch_mma<64, kNoBias>, launch_mma<64, kKeyBias>,
       launch_mma<64, kFullBias>},
      {launch_mma<128, kNoBias>, launch_mma<128, kKeyBias>,
       launch_mma<128, kFullBias>}};
  static const Launch kF32[3] = {launch_fma<float, 32>, launch_fma<float, 64>,
                                 launch_fma<float, 128>};
  static const Launch kB16[3] = {launch_fma<bf16, 32>, launch_fma<bf16, 64>,
                                 launch_fma<bf16, 128>};
  if (mma) return kMma[i][bias_kind];
  if (dtype == 0) return kF32[i];
  if (dtype == 1) return kB16[i];
  return nullptr;
}

}  // namespace

// q, k, v, o: contiguous (B, H, N, D) of `dtype` (0 = fp32, 1 = bf16),
// D in {32, 64, 128}; bias: fp32 or null, element (b, h, i, j) at
// b*sb_b + h*sb_h + i*sb_q + j*sb_k. bf16 runs on the tensor cores, fp32
// on the FMA pipe. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ecamp_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, long long sb_b, long long sb_h,
                                   long long sb_q, long long sb_k, void* o, int B, int H,
                                   int Nq, int Nk, int D, int dtype, float scale,
                                   void* stream) {
  const int bias_kind = bias == nullptr ? kNoBias : sb_q == 0 ? kKeyBias : kFullBias;
  const Launch launch = pick(dtype, D, use_mma(dtype, q, k, v, o), bias_kind);
  if (launch == nullptr || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale,
                static_cast<cudaStream_t>(stream));
}


