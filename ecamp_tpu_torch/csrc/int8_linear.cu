// int8-weight linear for Hopper (sm_90a), plain C interface:
//   y (M, N) bf16 = x (M, K) bf16 · bf16(float(q) · s[n])ᵀ + b
// with q (N, K) int8 row-major (a Linear's (out, in) weight quantized per
// output channel by serve/quantize.py), s (N,) fp32 and b (N,) bf16 or none.
//
// Replaces no Pallas kernel. The JAX package's `--quantize int8`
// (ecamp_tpu/serve/quantize.py:60-83) dequantises `q.astype(f32) * s`
// inside the jitted apply, and XLA fuses that convert into the consuming
// dot, so the weights leave device memory as int8. In torch ops the
// dequantised bf16 weight would be written and read again on every forward,
// more bytes than the unquantised path. This kernel is that fusion: it reads
// the int8 weight and widens it on chip.
//
// What bounds it on the H100: at serving's small M (197 rows an image) the
// weight read, N·K bytes (half of bf16's); at bucket 64's M = 12,608 the
// tensor cores (2·M·N·K operations).
// What the design does about it (simple first: wgmma, TMA and a cheaper
// widening are later work): a block computes a BM x BN tile of y with
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), each warp a 64 x 32 tile,
// over K in 32-deep stages, two stages in shared memory. While the tensor
// cores work on one stage, the next x tile is copied into the other with
// cp.async and the next q tile is loaded 16 bytes a thread into registers;
// after the products those bytes are widened to bf16(float(q) · s[n]) (an
// fp32 product rounded to nearest even: exactly JAX's dequantise-then-cast
// weight) and stored to the other stage. The epilogue adds the bias in fp32
// and rounds once to bf16. Rows past M and N are zero-filled on load and
// never stored. K must be a multiple of 16 and x and q 16-byte aligned (the
// wrapper checks). A problem with fewer 128 x 128 tiles than twice the SMs
// takes 64 x 64 tiles, so that M = 197 still spreads over the card.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBK = 32;             // K depth of a stage
constexpr int kLds = kBK + 8;       // shared row stride in bf16: 80 bytes, so
                                    // the 8 rows of an ldmatrix hit distinct banks
constexpr int kWM = 64, kWN = 32;   // a warp's tile of y

template <int BM, int BN>
struct Tile {
  static constexpr int kWarpsM = BM / kWM, kWarpsN = BN / kWN;
  static constexpr int kThreads = 32 * kWarpsM * kWarpsN;
  static constexpr int kXPer = BM * (kBK / 8) / kThreads;   // 16-byte x chunks a thread
  static constexpr int kQPer = BN * (kBK / 16) / kThreads;  // 16-byte q chunks a thread
  static_assert(BM % kWM == 0 && BN % kWN == 0, "whole warp tiles");
  static_assert(kXPer * kThreads == BM * (kBK / 8), "x chunks spread evenly");
  static_assert(kQPer * kThreads == BN * (kBK / 16), "q chunks spread evenly");
};

// 16 bytes global -> shared, zero-filled when !valid (src then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(hopper::smem_addr(p)));
}

// d += a (16 x 16, row) · b (16 x 8, col), fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// byte j of w, sign-extended
__device__ __forceinline__ float byte_f(unsigned w, int j) {
  return static_cast<float>(static_cast<int>(w << (24 - 8 * j)) >> 24);
}

// bf16(float(q) · s) of bytes j, j + 1 of w, packed low to high
__device__ __forceinline__ unsigned widen2(unsigned w, int j, float s) {
  __nv_bfloat162 h = __floats2bfloat162_rn(byte_f(w, j) * s, byte_f(w, j + 1) * s);
  return *reinterpret_cast<unsigned*>(&h);
}

// 16 int8 weights of one row -> 16 bf16 in shared memory at dst
__device__ __forceinline__ void widen_store(bf16* dst, uint4 v, float s) {
  const uint4 lo = make_uint4(widen2(v.x, 0, s), widen2(v.x, 2, s), widen2(v.y, 0, s),
                              widen2(v.y, 2, s));
  const uint4 hi = make_uint4(widen2(v.z, 0, s), widen2(v.z, 2, s), widen2(v.w, 0, s),
                              widen2(v.w, 2, s));
  reinterpret_cast<uint4*>(dst)[0] = lo;
  reinterpret_cast<uint4*>(dst)[1] = hi;
}

template <int BM, int BN>
__global__ void __launch_bounds__(Tile<BM, BN>::kThreads)
int8_linear_kernel(const bf16* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ s, const bf16* __restrict__ bias,
                   bf16* __restrict__ y, int M, int N, int K) {
  using T = Tile<BM, BN>;
  __shared__ __align__(16) bf16 xs[2][BM * kLds];
  __shared__ __align__(16) bf16 ws[2][BN * kLds];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / T::kWarpsN, wn = warp % T::kWarpsN;
  const long long m0 = (long long)blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  // a thread's q rows are the same at every stage: their scales load once
  int q_row[T::kQPer], q_col[T::kQPer];
  float q_s[T::kQPer];
#pragma unroll
  for (int i = 0; i < T::kQPer; ++i) {
    const int c = tid + i * T::kThreads;
    q_row[i] = c / (kBK / 16);
    q_col[i] = (c % (kBK / 16)) * 16;
    q_s[i] = n0 + q_row[i] < N ? s[n0 + q_row[i]] : 0.f;
  }

  auto load_x = [&](int stage, int k0) {
#pragma unroll
    for (int i = 0; i < T::kXPer; ++i) {
      const int c = tid + i * T::kThreads;
      const int r = c / (kBK / 8), col = (c % (kBK / 8)) * 8;
      const long long m = m0 + r;
      const int k = k0 + col;
      const bool ok = m < M && k < K;
      cp_async16(&xs[stage][r * kLds + col], ok ? x + m * K + k : x, ok);
    }
  };
  auto load_q = [&](uint4 (&v)[T::kQPer], int k0) {
#pragma unroll
    for (int i = 0; i < T::kQPer; ++i) {
      const int n = n0 + q_row[i], k = k0 + q_col[i];
      v[i] = n < N && k < K ? __ldg(reinterpret_cast<const uint4*>(q + (long long)n * K + k))
                            : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store_w = [&](int stage, const uint4 (&v)[T::kQPer]) {
#pragma unroll
    for (int i = 0; i < T::kQPer; ++i)
      widen_store(&ws[stage][q_row[i] * kLds + q_col[i]], v[i], q_s[i]);
  };

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  const int stages = (K + kBK - 1) / kBK;
  uint4 qv[T::kQPer];
  load_x(0, 0);
  cp_async_commit();
  load_q(qv, 0);
  store_w(0, qv);
  for (int kt = 0; kt < stages; ++kt) {
    const int cur = kt & 1;
    cp_async_wait_all();
    __syncthreads();  // stage cur is whole; every warp is done with the other
    const bool more = kt + 1 < stages;
    if (more) {
      load_x(cur ^ 1, (kt + 1) * kBK);
      cp_async_commit();
      load_q(qv, (kt + 1) * kBK);  // in flight during the products
    }
    const bf16* xa = xs[cur] + wm * kWM * kLds;
    const bf16* wb = ws[cur] + wn * kWN * kLds;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      unsigned a[4][4], b[2][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)  // rows lane % 16, k half lane / 16
        ldmatrix_x4(a[mi], xa + (mi * 16 + (lane & 15)) * kLds + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj)  // (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, ...)
        ldmatrix_x4(b[nj], wb + (nj * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLds + kk +
                               ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          mma_bf16(acc[mi][ni], a[mi], b[ni >> 1][(ni & 1) * 2], b[ni >> 1][(ni & 1) * 2 + 1]);
    }
    if (more) store_w(cur ^ 1, qv);
  }

  // epilogue: fragment (mi, ni) holds rows g and g + 8, columns 2t and 2t + 1
  const bool pairs = (N & 1) == 0;  // bf16x2 stores stay 4-byte aligned
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
    const int n = n0 + wn * kWN + ni * 8 + 2 * (lane & 3);
    float b0 = 0.f, b1 = 0.f;
    if (bias != nullptr) {
      if (n < N) b0 = __bfloat162float(bias[n]);
      if (n + 1 < N) b1 = __bfloat162float(bias[n + 1]);
    }
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long m = m0 + wm * kWM + mi * 16 + (lane >> 2) + h * 8;
        if (m >= M || n >= N) continue;
        const float v0 = acc[mi][ni][2 * h] + b0, v1 = acc[mi][ni][2 * h + 1] + b1;
        bf16* out = y + m * N + n;
        if (pairs) {
          *reinterpret_cast<__nv_bfloat162*>(out) = __floats2bfloat162_rn(v0, v1);
        } else {
          out[0] = __float2bfloat16(v0);
          if (n + 1 < N) out[1] = __float2bfloat16(v1);
        }
      }
  }
}

template <int BM, int BN>
int launch(const void* x, const void* q, const void* s, const void* b, void* y, int M, int N,
           int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_linear_kernel<BM, BN><<<grid, Tile<BM, BN>::kThreads, 0, st>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(s),
      static_cast<const bf16*>(b), static_cast<bf16*>(y), M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// b may be null (no bias). M, N > 0, K > 0 a multiple of 16, x and q 16-byte
// aligned, (M + 63) / 64 within the grid's y limit: the wrapper checks.
extern "C" int ecamp_int8_linear(const void* x, const void* q, const void* s, const void* b,
                                 void* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  static const int sms = hopper::sm_count();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long big = (long long)((M + 127) / 128) * ((N + 127) / 128);
  if (big >= 2LL * (sms > 0 ? sms : 132)) return launch<128, 128>(x, q, s, b, y, M, N, K, st);
  return launch<64, 64>(x, q, s, b, y, M, N, K, st);
}
