// Fused softmax attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/flash_attention.py::_attn_kernel
// (launched by _flash_attention_impl): per batch*head,
// softmax(Q K^T * scale + bias) V with fp32 logits and softmax, the
// probabilities rounded to the input dtype before the PV product, and the
// division by the softmax denominator taken once, after PV, in fp32.
//
// What bounds it on the H100: at the served shapes (N = 197 or 785, D = 64)
// each (batch*head) does 4*N*N*D flops on 4*N*D*2 bytes of q/k/v/o, about
// N/2 flops per byte in bf16, far above the card's ridge point, so it is
// compute-bound. This version runs on the plain FMA pipe (no tensor cores)
// and its inner loops execute one shared-memory load per FMA, so the
// shared-memory load rate is its limit: at (64, 12, 197, 64) bf16 it ran
// 1.22 ms, about 6.3 TFLOP/s (NVIDIA H100 80GB HBM3, 700.00 W).
// What the design does about it: the logits never reach device memory
// (online softmax over key tiles), K/V tiles are staged once in shared
// memory and read by all 64 query rows of a block, and four threads split
// each query row's D so registers hold q, the accumulator and one tile of
// logits. Tensor cores (wgmma) fed by TMA are the next step.
//
// Grid: x = batch*head, y = 64-query tiles. Block: 256 threads, four per
// query row; thread `part` of a row owns the columns part, part+4, ...
// (neighbouring threads read neighbouring shared-memory words). Ragged Nq/Nk
// edges are masked by bounds, with no padding copies. The optional fp32
// bias is read through four element strides (0 on a broadcast dim), which
// covers the (B,1,1,Nk) key-padding and the full (B,H,Nq,Nk) layouts.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kQTile = 64;
constexpr int kKTile = 64;
constexpr int kSplit = 4;  // threads per query row
constexpr int kThreads = kQTile * kSplit;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long sb_b, long long sb_h, long long sb_q, long long sb_k, void* o,
           int B, int H, int Nq, int Nk, float scale, cudaStream_t stream) {
  const size_t smem = 2 * kKTile * D * sizeof(T);
  auto kernel = attention_fwd_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B * H, (Nq + kQTile - 1) / kQTile);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(bias), sb_b, sb_h, sb_q, sb_k, static_cast<T*>(o),
      H, Nq, Nk, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, const void* bias,
               long long sb_b, long long sb_h, long long sb_q, long long sb_k, void* o,
               int B, int H, int Nq, int Nk, float scale, cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, k, v, o: contiguous (B, H, N, D) of `dtype` (0 = fp32, 1 = bf16);
// bias: fp32 or null, element (b, h, i, j) at b*sb_b + h*sb_h + i*sb_q + j*sb_k.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ecamp_attention_fwd(const void* q, const void* k, const void* v,
                                   const void* bias, long long sb_b, long long sb_h,
                                   long long sb_q, long long sb_k, void* o, int B, int H,
                                   int Nq, int Nk, int D, int dtype, float scale,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(D, q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, bias, sb_b, sb_h, sb_q, sb_k, o, B, H, Nq, Nk,
                                     scale, s);
  return (int)cudaErrorInvalidValue;
}
