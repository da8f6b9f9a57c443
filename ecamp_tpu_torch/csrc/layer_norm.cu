// LayerNorm forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/layer_norm.py::_ln_kernel
// (launched by _ln_pallas): LayerNorm over the last axis of a (rows, d)
// input, as _ln_reference computes it: the fp32 mean, then the fp32 mean of
// the squared deviations, rsqrt(var + eps), the fp32 affine
// ((x - mean) * rstd) * w + b, and the output in the input dtype.
//
// What bounds it on the H100: a row reduction plus an elementwise affine,
// about 8 flops an element against 4 bytes (bf16 in and out), far below the
// ridge point, so device-memory bytes bound it: (8192, 768) bf16 is 25.2 MB,
// 7.5 us at 3.35 TB/s. At that size the launch itself matters too: the
// pretraining step launches it 51 times.
// What the design does about it: one warp a row, rows taken in a
// grid-stride loop by as many blocks as fit on the card at once, so each
// row is read once, with 16-byte vector loads (3 a lane at d = 768 bf16,
// 2 at d = 512), kept in registers for both reductions (warp shuffles) and
// the affine, and written once with 16-byte stores. The fp32 weight and
// bias stay in registers across a warp's rows. d not a multiple of the
// vector width, d > 1024 or unaligned pointers take a plain strided path
// (one warp a row, three passes over the row from L1/L2). The launch is one
// ctypes call into this library; eps is a runtime argument.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps, one row each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 1024;    // widest row the vector path keeps in registers

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// kPer 16-byte chunks a lane: lane c holds chunks c, c + 32, ...
template <typename T, int kPer>
__global__ void __launch_bounds__(kThreads)
ln_fwd_vec_kernel(const T* __restrict__ x, const float* __restrict__ w,
                  const float* __restrict__ b, T* __restrict__ y, int rows, int d, float eps) {
  constexpr int E = 16 / sizeof(T);  // elements a chunk
  const int lane = threadIdx.x % 32;
  const int chunks = d / E;
  float wr[kPer][E], br[kPer][E];
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int c = lane + 32 * i;
#pragma unroll
    for (int e = 0; e < E; e += 4) {
      float4 wv = make_float4(0.f, 0.f, 0.f, 0.f), bv = wv;
      if (c < chunks) {
        wv = *reinterpret_cast<const float4*>(w + c * E + e);
        bv = *reinterpret_cast<const float4*>(b + c * E + e);
      }
      const float wa[4] = {wv.x, wv.y, wv.z, wv.w}, ba[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        wr[i][e + j] = wa[j];
        br[i][e + j] = ba[j];
      }
    }
  }
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const T* xr = x + row * d;
    float xv[kPer][E];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      uint4 raw = make_uint4(0u, 0u, 0u, 0u);
      if (c < chunks) raw = *reinterpret_cast<const uint4*>(xr + c * E);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int e = 0; e < E; ++e) {
        xv[i][e] = to_f(v[e]);
        sum += xv[i][e];
      }
    }
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      if (lane + 32 * i < chunks) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          xv[i][e] -= mean;
          sq += xv[i][e] * xv[i][e];
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    T* yr = y + row * d;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = lane + 32 * i;
      if (c < chunks) {
        uint4 raw;
        T* out = reinterpret_cast<T*>(&raw);
#pragma unroll
        for (int e = 0; e < E; ++e) out[e] = from_f<T>(xv[i][e] * rstd * wr[i][e] + br[i][e]);
        *reinterpret_cast<uint4*>(yr + c * E) = raw;
      }
    }
  }
}

// any d and alignment: one warp a row, strided over its columns
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_fwd_plain_kernel(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  for (long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32; row < rows;
       row += (long long)gridDim.x * kWarps) {
    const T* xr = x + row * d;
    float sum = 0.f;
    for (int c = lane; c < d; c += 32) sum += to_f(xr[c]);
    const float mean = warp_sum(sum) / d;
    float sq = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xc = to_f(xr[c]) - mean;
      sq += xc * xc;
    }
    const float rstd = rsqrtf(warp_sum(sq) / d + eps);
    T* yr = y + row * d;
    for (int c = lane; c < d; c += 32)
      yr[c] = from_f<T>((to_f(xr[c]) - mean) * rstd * w[c] + b[c]);
  }
}

template <typename T>
using LnKernel = void (*)(const T*, const float*, const float*, T*, int, int, float);

// blocks: enough to give every row a warp, at most what fits on the card
template <typename T, LnKernel<T> kKernel>
int launch(const void* x, const void* w, const void* b, void* y, int rows, int d, float eps,
           cudaStream_t stream) {
  static int per_sm = 0;  // resident blocks an SM: a property of the kernel
  cudaError_t err = cudaSuccess;
  if (per_sm == 0) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, kThreads, 0);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long fit = (long long)sms * per_sm;
  const long long want = ((long long)rows + kWarps - 1) / kWarps;
  kKernel<<<(int)(want < fit ? want : fit), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<T*>(y), rows, d, eps);
  return (int)cudaGetLastError();
}

// per: 16-byte chunks a lane on the vector path (d / E / 32, rounded up)
template <typename T>
int dispatch(bool vec, int per, const void* x, const void* w, const void* b, void* y, int rows,
             int d, float eps, cudaStream_t s) {
  if (!vec) return launch<T, ln_fwd_plain_kernel<T>>(x, w, b, y, rows, d, eps, s);
  switch (per) {
    case 1: return launch<T, ln_fwd_vec_kernel<T, 1>>(x, w, b, y, rows, d, eps, s);
    case 2: return launch<T, ln_fwd_vec_kernel<T, 2>>(x, w, b, y, rows, d, eps, s);
    case 3: return launch<T, ln_fwd_vec_kernel<T, 3>>(x, w, b, y, rows, d, eps, s);
    case 4: return launch<T, ln_fwd_vec_kernel<T, 4>>(x, w, b, y, rows, d, eps, s);
  }
  if constexpr (sizeof(T) == 4) {  // fp32 rows of up to kMaxD take 8
    switch (per) {
      case 5: return launch<T, ln_fwd_vec_kernel<T, 5>>(x, w, b, y, rows, d, eps, s);
      case 6: return launch<T, ln_fwd_vec_kernel<T, 6>>(x, w, b, y, rows, d, eps, s);
      case 7: return launch<T, ln_fwd_vec_kernel<T, 7>>(x, w, b, y, rows, d, eps, s);
      case 8: return launch<T, ln_fwd_vec_kernel<T, 8>>(x, w, b, y, rows, d, eps, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// x, y: contiguous (rows, d) of `dtype` (0 = fp32, 1 = bf16); w, b: (d,)
// fp32. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ecamp_layer_norm_fwd(const void* x, const void* w, const void* b, void* y,
                                    int rows, int d, int dtype, float eps, void* stream) {
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(b) | reinterpret_cast<uintptr_t>(y);
  const int E = dtype == 1 ? 8 : 4;  // elements a 16-byte chunk
  const bool vec = d % E == 0 && d <= kMaxD && (bits & 15) == 0;
  const int per = (d / E + 31) / 32;
  if (dtype == 0) return dispatch<float>(vec, per, x, w, b, y, rows, d, eps, s);
  if (dtype == 1) return dispatch<bf16>(vec, per, x, w, b, y, rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}
