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
//   * bf16 (the model's compute dtype): a FlashAttention-3 style kernel on
//     TMA and wgmma (bf16 in, fp32 accumulate), on a persistent grid of
//     (batch*head, 64-query tile) items: one producer warp keeps two Q
//     buffers and two rings of 64-key K and V tiles filled by TMA behind
//     mbarriers and stores each O by TMA, and one consumer warpgroup runs
//     S = Q K^T from shared memory and O += P V with P in registers, the
//     next tile's S issued before this tile's softmax. So q, k, v are read
//     once from device memory (K and V once a 64-query tile, from L2 after
//     the first), the loads and stores take no instructions of the
//     consumers, one item's loads and store run under another's products,
//     the logits never leave the SM, and o is written once. Two or three
//     blocks an SM keep the memory-bound shapes' bytes in flight; at
//     N = 785 the products run on the tensor cores while the exponentials
//     of the next tile are computed.
//   * fp32 (and bf16 whose pointers are not 16-byte aligned): the FMA pipe,
//     one block per (batch*head, 64-query tile), four threads per query
//     row, K/V tiles staged in shared memory. TF32 would miss the fp32
//     tolerance; no model path runs it.
// Ragged Nq / Nk edges are masked by bounds (zero-filled loads, -inf
// logits past Nk), with no padding copies. The optional fp32 bias is read
// through four element strides (0 on a broadcast dim), which covers the
// (B,1,1,Nk) key-padding and the full (B,H,Nq,Nk) layouts; a bias that
// does not vary over the query rows is read once a key tile. A row whose
// logits so far are all -inf keeps its exponents finite (the BERT mask is
// finfo(fp32).min, not -inf).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using namespace hopper;
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
// tensor cores (bf16): TMA + wgmma

namespace wg {

constexpr int kBM = 64;                   // query rows an item: one consumer warpgroup
constexpr int kBN = 64;                   // keys a tile
constexpr int kConsumers = 128;           // the consumer warpgroup
constexpr int kThreads = kConsumers + 32; // and the producer warp
constexpr int kStages = 2;                // K tiles (and V tiles) in shared memory
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory tiles of head dim D, as TMA writes them: rows of one
// swizzle width (64 bf16 = 128 bytes, or at D = 32 32 bf16 = 64 bytes),
// D / width such boxes side by side, each of all the tile's rows.
template <int D>
struct Tile {
  // blocks an SM: at D = 128 the shared memory (97 KB a block) and the
  // registers of O allow two, else three
  static constexpr int kBlocks = D == 128 ? 2 : 3;
  static constexpr int kBoxCols = D == 32 ? 32 : 64;
  static constexpr int kRowBytes = 2 * kBoxCols;
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr int kAtom = 8 * kRowBytes;  // 8 rows: the descriptors' SBO
  static constexpr unsigned kLayout = D == 32 ? 2 : 1;  // 64- or 128-byte swizzle
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kKVBytes = kBN * D * 2;  // one K or V tile
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kKVBytes + 1024;

  // byte offset of element (row, col) in a tile of `rows` rows: the TMA
  // swizzle moves 16-byte chunk c of row r to c ^ (r % 8) (128-byte rows)
  // or c ^ ((r / 2) % 4) (64-byte rows)
  __device__ static int offset(int rows, int row, int col) {
    const int c = col % kBoxCols;
    const int chunk = c / 8 ^ (kRowBytes == 128 ? row % 8 : row / 2 % 4);
    return col / kBoxCols * rows * kRowBytes + row * kRowBytes + chunk * 16 + c % 8 * 2;
  }

  // K-major operand (Q or K, D deep) of `rows` rows at k-step kk: 16
  // columns are 32 bytes inside a swizzle row
  __device__ static uint64_t k_desc(const unsigned char* tile, int rows, int kk) {
    const int col = 16 * kk;
    return smem_desc(tile + col / kBoxCols * rows * kRowBytes + col % kBoxCols * 2, 16, kAtom,
                     kLayout);
  }

  // V as the MN-major B of P V at k-step kk: 16 keys are two 8-row groups,
  // the column boxes kBN rows apart (LBO)
  __device__ static uint64_t v_desc(const unsigned char* tile, int kk) {
    return smem_desc(tile + 16 * kk * kRowBytes, kBN * kRowBytes, kAtom, kLayout);
  }
};

// O (64 x D) += P V for one 16-key step, P from registers, V MN-major
template <int D>
__device__ __forceinline__ void pv_step(float (&o)[D / 2], const unsigned (&p)[4], uint64_t dv) {
  if constexpr (D == 32)
    wgmma_m64n32_rs<1>(o, p, dv);
  else if constexpr (D == 64)
    wgmma_m64n64_rs<1>(o, p, dv);
  else
    wgmma_m64n128_rs<1>(o, p, dv);
}

}  // namespace wg

// the bias a launch takes: none, one that does not vary over the query
// rows (the key-padding mask, read a key tile at a time into registers),
// or any other, read through its strides
enum BiasKind { kNoBias = 0, kKeyBias = 1, kFullBias = 2 };

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

// A persistent grid: block b takes the work items (batch*head, 64-query
// tile) b, b + grid, b + 2 grid, ..., numbered with the query tiles of a
// batch*head next to each other, so the blocks at work at one time share
// K and V in L2. The producer warp's one thread loads each item's Q tile
// into one of two Q buffers and the K and V tiles into two rings of
// kStages behind mbarriers, by TMA through 3-D tensor maps (D, N, B*H): a
// box past a ragged Nk reads zeros, never the next batch*head's rows. It
// runs ahead into the next item while the consumers finish one, and it
// stores each item's O by TMA from that item's Q buffer (rows past Nq are
// not written) before loading the buffer again. The consumer warpgroup
// owns an item's 64 query rows; a thread holds rows g = lane/4 and g + 8
// of its warp's 16 (hopper.cuh gives the fragment layout).
//
// Tile t: S_t = Q K_t^T by wgmma from shared memory is issued, then
// O += P_{t-1} V_{t-1} with P_{t-1} in registers, so the products of one
// tile run while the softmax of the next is computed. The logits S' are S
// * scale + bias, or without a bias S itself with the scale folded into
// f = scale * log2(e), so that p = 2^((S' - m) f) is one FMA and one ex2 an
// element. With a bias the difference is taken first: a finfo.min mask
// times log2(e) would overflow. Only a ragged last tile takes the bounds
// mask. P is rounded to bf16 straight from S's accumulators into A
// fragments (the m64nN accumulator layout of two adjacent 8-column blocks
// is the A fragment of one 16-deep step). O is divided by the denominator
// once, after the last P V, and written into the item's Q buffer in the
// TMA store's swizzled layout.
template <int D, int kBias>
__global__ void __launch_bounds__(wg::kThreads, wg::Tile<D>::kBlocks)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap to, const float* __restrict__ bias,
                           long long sb_b, long long sb_h, long long sb_q, long long sb_k, int H,
                           int Nq, int Nk, int items, float scale) {
  using T = wg::Tile<D>;
  using wg::kBM;
  using wg::kBN;
  using wg::kStages;
  constexpr int kNB = kBN / 8;  // 8-column blocks of S
  extern __shared__ __align__(16) unsigned char smem_tc[];
  // qfull: an item's Q has landed; ofull: its O is in the Q buffer
  __shared__ __align__(8) uint64_t qfull[2], ofull[2], kfull[kStages], kempty[kStages],
      vfull[kStages], vempty[kStages];
  // the swizzle pattern repeats every 1024 bytes: tiles start on it
  unsigned char* qs = smem_tc + ((1024 - (smem_addr(smem_tc) & 1023)) & 1023);  // 2 Q tiles
  unsigned char* ks = qs + 2 * T::kQBytes;         // kStages K tiles
  unsigned char* vs = ks + kStages * T::kKVBytes;  // kStages V tiles
  const int n_qt = (Nq + kBM - 1) / kBM;
  const int nt = (Nk + kBN - 1) / kBN;
  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(&qfull[b], 1);
      mbar_init(&ofull[b], wg::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&kfull[s], 1);
      mbar_init(&vfull[s], 1);
      mbar_init(&kempty[s], wg::kConsumers);
      mbar_init(&vempty[s], wg::kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= wg::kConsumers) {  // the producer warp
    if (threadIdx.x == wg::kConsumers) {
      // item j's O, from Q buffer j % 2, once the consumers have written it
      auto store_o = [&](int j) {
        const int item = blockIdx.x + j * gridDim.x;
        mbar_wait(&ofull[j % 2], j / 2 % 2);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_store_3d(&to, qs + j % 2 * T::kQBytes + b * kBM * T::kRowBytes, b * T::kBoxCols,
                       item % n_qt * kBM, item / n_qt);
        tma_store_wait();
      };
      int c = 0;  // K and V tiles loaded so far
      int j = 0;  // items begun
      for (int item = blockIdx.x; item < items; item += gridDim.x, ++j) {
        const int bh = item / n_qt, q0 = item % n_qt * kBM;
        if (j >= 2) store_o(j - 2);  // the buffer's last O, then its next Q
        mbar_expect_tx(&qfull[j % 2], T::kQBytes);
        for (int b = 0; b < T::kBoxes; ++b)
          tma_load_3d(qs + j % 2 * T::kQBytes + b * kBM * T::kRowBytes, &tq, &qfull[j % 2],
                      b * T::kBoxCols, q0, bh);
        for (int t = 0; t < nt; ++t, ++c) {
          const int s = c % kStages;
          const unsigned ph = c / kStages % 2;
          mbar_wait(&kempty[s], ph ^ 1);
          mbar_expect_tx(&kfull[s], T::kKVBytes);
          for (int b = 0; b < T::kBoxes; ++b)
            tma_load_3d(ks + s * T::kKVBytes + b * kBN * T::kRowBytes, &tk, &kfull[s],
                        b * T::kBoxCols, t * kBN, bh);
          mbar_wait(&vempty[s], ph ^ 1);
          mbar_expect_tx(&vfull[s], T::kKVBytes);
          for (int b = 0; b < T::kBoxes; ++b)
            tma_load_3d(vs + s * T::kKVBytes + b * kBN * T::kRowBytes, &tv, &vfull[s],
                        b * T::kBoxCols, t * kBN, bh);
        }
      }
      for (int jj = j < 2 ? 0 : j - 2; jj < j; ++jj) store_o(jj);
    }
    return;
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int row0 = warp * 16 + g;  // rows row0 and row0 + 8 of the item
  const float f = kBias == kNoBias ? scale * wg::kLog2e : wg::kLog2e;
  const float* bb = nullptr;
  const float* brow[2] = {nullptr, nullptr};  // rows g, g + 8, clamped inside Nq
  float o[D / 2];   // O, accumulator fragments
  float sc[kBN / 2];  // S of the tile
  unsigned pp[kBN / 16][4];  // P of the previous tile, A fragments of its 16-key steps
  float m[2], l[2];  // running max of S' and denominator (this thread's columns), rows g, g + 8
  auto p_of = [&](float x, float mu) {  // 2^((x - mu) f)
    return exp2_approx(kBias == kNoBias ? fmaf(x, f, -mu * f) : (x - mu) * f);
  };
  const unsigned char* q = qs;  // the item's Q tile
  int c = 0;                    // K and V tiles used so far

  // the item's K tile t, and V tile t, in shared memory
  auto wait_k = [&](int t) { mbar_wait(&kfull[(c + t) % kStages], (c + t) / kStages % 2); };
  auto wait_v = [&](int t) { mbar_wait(&vfull[(c + t) % kStages], (c + t) / kStages % 2); };
  // S = Q K^T of the item's tile t issued. Its tile and P V's are waited
  // for before the warpgroup's fence: a wgmma after a spin on a barrier
  // would need a fence of its own, which ptxas places itself and then
  // serialises the wgmmas.
  auto issue_s = [&](int t) {
    const int s = (c + t) % kStages;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_m64n64<0, 0>(sc, T::k_desc(q, kBM, kk), T::k_desc(ks + s * T::kKVBytes, kBN, kk),
                         kk > 0);
    wg_commit();
  };
  // O += P V of the item's tile t issued
  auto issue_pv = [&](int t) {
    const int s = (c + t) % kStages;
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
      wg::pv_step<D>(o, pp[kk], T::v_desc(vs + s * T::kKVBytes, kk));
    wg_commit();
  };
  // the key-padding bias of this thread's columns of tile t (none past
  // Nk), loaded a tile ahead of its use
  auto load_key_bias = [&](int t, float (&kb)[kNB][2]) {
    if (kBias == kKeyBias) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = t * kBN + 8 * j + 2 * t4 + e;
          kb[j][e] = col < Nk ? bb[(long long)col * sb_k] : 0.f;
        }
    }
  };
  // the online softmax of S_t, done: P_t as A fragments into pc (16-key
  // step kk takes column blocks 2 kk, registers 0 and 1, and 2 kk + 1, 2
  // and 3), the factor of the running O and denominator into alpha
  auto softmax = [&](int t, const float (&kb)[kNB][2], unsigned (&pc)[kBN / 16][4],
                     float (&alpha)[2]) {
    const int k0 = t * kBN;
    // S' (fragment i is row g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t4
    // + i % 2), then the bounds mask on a ragged last tile
    if (kBias != kNoBias) {
#pragma unroll
      for (int j = 0; j < kNB; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t4 + e;
            const float b = kBias == kKeyBias ? kb[j][e]
                            : col < Nk        ? brow[r][(long long)col * sb_k]
                                              : 0.f;
            sc[4 * j + 2 * r + e] = fmaf(sc[4 * j + 2 * r + e], scale, b);
          }
    }
    if (k0 + kBN > Nk) {
#pragma unroll
      for (int i = 0; i < kBN / 2; ++i)
        if (k0 + 8 * (i / 4) + 2 * t4 + i % 2 >= Nk) sc[i] = -CUDART_INF_F;
    }
    // the tile's row max over the 4 threads of a row
    float mu[2];  // the max in use, finite
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float tmax = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < kNB; ++j)
        tmax = fmaxf(tmax, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m[r], tmax);
      // a row whose logits so far are all -inf keeps exponents finite
      mu[r] = m_new == -CUDART_INF_F ? 0.f : m_new;
      alpha[r] = p_of(m[r], mu[r]);
      l[r] *= alpha[r];
      m[r] = m_new;
    }
    // P = 2^((S' - m) f) in fp32 into the denominator, rounded to bf16
    // (Pallas: p.astype(v.dtype))
#pragma unroll
    for (int j = 0; j < kNB; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float p0 = p_of(sc[4 * j + 2 * r], mu[r]);
        const float p1 = p_of(sc[4 * j + 2 * r + 1], mu[r]);
        l[r] += p0 + p1;
        pc[j / 2][2 * (j % 2) + r] = pack_bf16(p0, p1);
      }
  };

  int j = 0;  // items begun
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++j, c += nt) {
    const int bh = item / n_qt, q0 = item % n_qt * kBM;
    q = qs + j % 2 * T::kQBytes;
    if (kBias != kNoBias) {
      bb = bias + (long long)(bh / H) * sb_b + (long long)(bh % H) * sb_h;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        brow[r] = bb + (long long)min(q0 + row0 + 8 * r, Nq - 1) * sb_q;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = -CUDART_INF_F;
      l[r] = 0.f;
    }
    float alpha[2];
    float kb[kNB][2], kb_next[kNB][2];  // the key-padding bias of tiles t and t + 1
    load_key_bias(0, kb);
    mbar_wait(&qfull[j % 2], j / 2 % 2);
    {  // tile 0: O is still zero, nothing to rescale
      wait_k(0);
      wg_fence();
      issue_s(0);
      load_key_bias(1, kb_next);
      wg_wait<0>();
      fence_regs(sc);
      mbar_arrive(&kempty[c % kStages]);
      softmax(0, kb, pp, alpha);
    }
    for (int t = 1; t < nt; ++t) {
      wait_k(t);
      wait_v(t - 1);
      wg_fence();
      issue_s(t);
      issue_pv(t - 1);
#pragma unroll
      for (int jj = 0; jj < kNB; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) kb[jj][e] = kb_next[jj][e];
      load_key_bias(t + 1, kb_next);
      wg_wait<1>();  // S_t is done: K_t is free
      fence_regs(sc);
      mbar_arrive(&kempty[(c + t) % kStages]);
      unsigned pc[kBN / 16][4];
      softmax(t, kb, pc, alpha);
      wg_wait<0>();  // P_{t-1} V_{t-1} is done: O may change, V_{t-1} is free
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pp[kk]);
      mbar_arrive(&vempty[(c + t - 1) % kStages]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[i / 2 % 2];
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pp[kk][e] = pc[kk][e];
    }
    // the last tile's P V
    wait_v(nt - 1);
    wg_fence();
    issue_pv(nt - 1);
    wg_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) fence_regs(pp[kk]);
    mbar_arrive(&vempty[(c + nt - 1) % kStages]);

    // O / l in fp32, rounded once, into the Q buffer (the item's last S
    // read it before the waits above) in the TMA store's layout; the
    // producer stores it
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    unsigned char* out = qs + j % 2 * T::kQBytes;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<unsigned*>(out + T::offset(kBM, row0 + 8 * r, 8 * jj + 2 * t4)) =
            pack_bf16(o[4 * jj + 2 * r] / l[r], o[4 * jj + 2 * r + 1] / l[r]);
    async_proxy_fence();
    mbar_arrive(&ofull[j % 2]);
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
int launch_wgmma(const void* q, const void* k, const void* v, const void* bias, long long sb_b,
                 long long sb_h, long long sb_q, long long sb_k, void* o, int B, int H, int Nq,
                 int Nk, float scale, cudaStream_t stream) {
  using T = wg::Tile<D>;
  const long long blocks = (long long)B * H * ((Nq + wg::kBM - 1) / wg::kBM);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv, to;
  if (!bf16_map_3d(&tq, q, B * H, Nq, D, wg::kBM, T::kBoxCols) ||
      !bf16_map_3d(&tk, k, B * H, Nk, D, wg::kBN, T::kBoxCols) ||
      !bf16_map_3d(&tv, v, B * H, Nk, D, wg::kBN, T::kBoxCols) ||
      !bf16_map_3d(&to, o, B * H, Nq, D, wg::kBM, T::kBoxCols))
    return (int)cudaErrorInvalidValue;
  auto kernel = attention_fwd_wgmma_kernel<D, kBias>;
  const cudaError_t err = allow_smem(kernel, T::kSmem);
  if (err != cudaSuccess) return (int)err;
  // persistent: T::kBlocks blocks for each SM, or one for each item if fewer
  const long long slots = (long long)sm_count() * T::kBlocks;
  if (slots <= 0) return (int)cudaErrorInvalidDevice;
  kernel<<<(unsigned)(blocks < slots ? blocks : slots), wg::kThreads, T::kSmem, stream>>>(
      tq, tk, tv, to, static_cast<const float*>(bias), sb_b, sb_h, sb_q, sb_k, H, Nq, Nk,
      (int)blocks, scale);
  return (int)cudaGetLastError();
}

// the tensor-core path: bf16 with 16-byte aligned q, k, v, o (what TMA
// takes; D is a multiple of 8, so every row is then aligned too)
bool use_tensor_cores(int dtype, const void* q, const void* k, const void* v, const void* o) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  return dtype == 1 && (bits & 15) == 0;
}

using Launch = int (*)(const void*, const void*, const void*, const void*, long long, long long,
                       long long, long long, void*, int, int, int, int, float, cudaStream_t);

// the launch for a dtype, head dim, path and bias kind; null for what no
// kernel takes
Launch pick(int dtype, int D, bool tensor_cores, int bias_kind) {
  const int i = D == 32 ? 0 : D == 64 ? 1 : D == 128 ? 2 : -1;
  if (i < 0) return nullptr;
  static const Launch kTc[3][3] = {
      {launch_wgmma<32, kNoBias>, launch_wgmma<32, kKeyBias>, launch_wgmma<32, kFullBias>},
      {launch_wgmma<64, kNoBias>, launch_wgmma<64, kKeyBias>, launch_wgmma<64, kFullBias>},
      {launch_wgmma<128, kNoBias>, launch_wgmma<128, kKeyBias>, launch_wgmma<128, kFullBias>}};
  static const Launch kF32[3] = {launch_fma<float, 32>, launch_fma<float, 64>,
                                 launch_fma<float, 128>};
  static const Launch kB16[3] = {launch_fma<bf16, 32>, launch_fma<bf16, 64>,
                                 launch_fma<bf16, 128>};
  if (tensor_cores) return kTc[i][bias_kind];
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
  const Launch launch = pick(dtype, D, use_tensor_cores(dtype, q, k, v, o), bias_kind);
  if (launch == nullptr || B <= 0 || H <= 0 || Nq <= 0 || Nk <= 0)
    return (int)cudaErrorInvalidValue;
  return launch(q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale,
                static_cast<cudaStream_t>(stream));
}


