// SR head conv stack forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/sr_head.py::_sr_kernel (launched
// by _sr_conv_stack_impl): per image, channels-first,
//   out = relu(conv3x3(relu(conv3x3(x) + b1)) + b2 + x)
// with C = 3, zero padding, fp32 accumulation, output in the input dtype.
//
// What bounds it on the H100: a 448^2 image is 1.2 MB in bf16, read once
// and written once, against 324 flops a pixel (two convs of 81 FMAs for
// the three channels): 27 flops a byte in bf16 and 13.5 in fp32, about the
// 20 flops a byte at which the fp32 FMA pipe (67 TFLOP/s) meets device
// memory (3.35 TB/s). So neither bytes nor FMAs may be wasted, and both
// bound it only once the stencil's neighbours come from shared memory.
// What the design does about it: one block stages its input tile with a
// 2-pixel halo in shared memory
// once (global reads are row-contiguous), computes conv1 + relu on the
// +1 ring into a second shared tile, and conv2 + residual + relu from
// there, so each input pixel is read from device memory once (plus the
// halo) and the intermediate never leaves the SM.
//
// Grid: x = 64-column tiles, y = 16-row tiles, z = images; 256 threads a
// block. Ragged last tiles are masked by bounds. The conv1 ring is zeroed
// outside the true image border, as the Pallas kernel does
// (sr_head.py:49-65), because torch zero-pads conv2's input. Weights are
// OIHW (the port's conv parameters), packed with the biases into one fp32
// device buffer [w1 (81), b1 (3), w2 (81), b2 (3)] that each block copies
// into shared memory, so a call needs no host-to-device copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 3;
constexpr int kTileH = 16;
constexpr int kTileW = 64;
constexpr int kThreads = 256;
constexpr int kInH = kTileH + 4;   // 2-pixel halo for the two convs
constexpr int kInW = kTileW + 4;
constexpr int kMidH = kTileH + 2;  // conv1 evaluated on the +1 ring
constexpr int kMidW = kTileW + 2;
constexpr int kW = kC * kC * 9;    // one conv's weights
constexpr int kParams = 2 * (kW + kC);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// OIHW index of w[co][ci][dy][dx]
__device__ __forceinline__ int widx(int co, int ci, int dy, int dx) {
  return ((co * kC + ci) * 3 + dy) * 3 + dx;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sr_conv_stack_kernel(const T* __restrict__ x, const float* __restrict__ params,
                     T* __restrict__ out, int H, int W) {
  __shared__ float xs[kC][kInH][kInW];
  __shared__ float ys[kC][kMidH][kMidW];
  __shared__ float ps[kParams];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * kTileH;
  const int col0 = blockIdx.x * kTileW;
  const long long plane = (long long)H * W;
  const T* xb = x + (long long)blockIdx.z * kC * plane;
  T* ob = out + (long long)blockIdx.z * kC * plane;

  for (int i = tid; i < kParams; i += kThreads) ps[i] = params[i];
  for (int i = tid; i < kC * kInH * kInW; i += kThreads) {
    const int c = i / (kInH * kInW);
    const int r = (i / kInW) % kInH;
    const int cc = i % kInW;
    const int gr = row0 - 2 + r;
    const int gc = col0 - 2 + cc;
    float v = 0.f;
    if (gr >= 0 && gr < H && gc >= 0 && gc < W) v = to_f(xb[c * plane + (long long)gr * W + gc]);
    xs[c][r][cc] = v;
  }
  __syncthreads();

  const float* w1 = ps;
  const float* b1 = ps + kW;
  const float* w2 = ps + kW + kC;
  const float* b2 = ps + 2 * kW + kC;

  // conv1 + relu on the (kTileH+2, kTileW+2) ring; ring point (r, cc) is
  // image pixel (row0 - 1 + r, col0 - 1 + cc)
  for (int i = tid; i < kMidH * kMidW; i += kThreads) {
    const int r = i / kMidW;
    const int cc = i % kMidW;
    const int gr = row0 - 1 + r;
    const int gc = col0 - 1 + cc;
    const bool inside = gr >= 0 && gr < H && gc >= 0 && gc < W;
    float acc[kC];
#pragma unroll
    for (int co = 0; co < kC; ++co) acc[co] = b1[co];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          const float t = xs[ci][r + dy][cc + dx];
#pragma unroll
          for (int co = 0; co < kC; ++co) acc[co] = fmaf(w1[widx(co, ci, dy, dx)], t, acc[co]);
        }
#pragma unroll
    for (int co = 0; co < kC; ++co) ys[co][r][cc] = inside ? fmaxf(acc[co], 0.f) : 0.f;
  }
  __syncthreads();

  // conv2 + b2 + the residual from the staged input, relu, store
  for (int i = tid; i < kTileH * kTileW; i += kThreads) {
    const int r = i / kTileW;
    const int cc = i % kTileW;
    const int gr = row0 + r;
    const int gc = col0 + cc;
    if (gr >= H || gc >= W) continue;
    float acc[kC];
#pragma unroll
    for (int co = 0; co < kC; ++co) acc[co] = b2[co];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy)
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int ci = 0; ci < kC; ++ci) {
          const float t = ys[ci][r + dy][cc + dx];
#pragma unroll
          for (int co = 0; co < kC; ++co) acc[co] = fmaf(w2[widx(co, ci, dy, dx)], t, acc[co]);
        }
    const long long off = (long long)gr * W + gc;
#pragma unroll
    for (int co = 0; co < kC; ++co)
      ob[co * plane + off] = from_f<T>(fmaxf(acc[co] + xs[co][r + 2][cc + 2], 0.f));
  }
}

template <typename T>
int launch(const void* x, const void* params, void* out, int N, int H, int W,
           cudaStream_t stream) {
  dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, N);
  sr_conv_stack_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(params), static_cast<T*>(out), H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x, out: contiguous (N, 3, H, W) of `dtype` (0 = fp32, 1 = bf16);
// params: 168 fp32 values [w1 OIHW, b1, w2 OIHW, b2] on the device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int ecamp_sr_conv_stack_fwd(const void* x, const void* params, void* out, int N,
                                       int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || N > 65535 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch<float>(x, params, out, N, H, W, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, params, out, N, H, W, s);
  return (int)cudaErrorInvalidValue;
}
