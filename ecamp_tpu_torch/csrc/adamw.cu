// Multi-tensor AdamW update for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/fused_adamw.py::_adamw_kernel
// (launched per leaf by _leaf_update_pallas) with one launch for every
// leaf. Per element, in optax.adamw's op order:
//   g  = (g / gdiv) * gmul                  clip folded in as two scalars
//   m  = (1 - b1) * g + b1 * m
//   v  = (1 - b2) * (g * g) + b2 * v
//   u  = (m / bc1) / (sqrt(v / bc2) + eps)  bc_i = 1 - b_i^(t+1)
//   u  = u + wd * p                         only where the leaf decays
//   p  = p - lr * u
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn), so
// nvcc contracts nothing into an FMA and the result is the per-leaf
// PyTorch formula's, rounding for rounding; division and sqrt are
// IEEE-rounded in both.
//
// What bounds it on the H100: 28 bytes an element (read g, m, v, p; write
// m, v, p) against about 15 flops, far below the ridge point, so device
// memory bytes bound it: 182.6M fp32 parameters are 5.1 GB, 1.5 ms at
// 3.35 TB/s. What the design does about it: one pass over each element,
// 16-byte vector loads and stores where a leaf's four pointers are
// aligned, p, m and v updated in place, and no per-leaf launch or padding
// copy. The host builds a device table of leaves (pointers, sizes, decay)
// and of chunks (leaf, start) once per parameter set; each block updates
// one chunk of one leaf. The five scalars [lr, bc1, bc2, gdiv, gmul] are
// read from a device buffer, so the schedule and the clip need no host
// synchronisation.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps;  // omb = 1 - b, rounded once on the host
};

struct Scalars {
  float lr, bc1, bc2, gdiv, gmul, wd;
};

__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v, const Hyper& h,
                                      const Scalars& s) {
  g = __fmul_rn(__fdiv_rn(g, s.gdiv), s.gmul);
  m = __fadd_rn(__fmul_rn(h.omb1, g), __fmul_rn(h.b1, m));
  v = __fadd_rn(__fmul_rn(h.omb2, __fmul_rn(g, g)), __fmul_rn(h.b2, v));
  float u = __fdiv_rn(__fdiv_rn(m, s.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, s.bc2)), h.eps));
  if (s.wd != 0.f) u = __fadd_rn(u, __fmul_rn(s.wd, p));
  p = __fsub_rn(p, __fmul_rn(s.lr, u));
}

// ptrs: (L, 4) as p, g, m, v device addresses; numel, wd: (L);
// chunk_leaf, chunk_start: (n_chunks); scal: [lr, bc1, bc2, gdiv, gmul].
__global__ void __launch_bounds__(kThreads)
adamw_multi_kernel(const long long* __restrict__ ptrs, const long long* __restrict__ numel,
                   const float* __restrict__ wd, const int* __restrict__ chunk_leaf,
                   const long long* __restrict__ chunk_start, const float* __restrict__ scal,
                   long long chunk, Hyper h) {
  const int leaf = chunk_leaf[blockIdx.x];
  const long long start = chunk_start[blockIdx.x];
  const long long end = min(start + chunk, numel[leaf]);
  float* p = reinterpret_cast<float*>(ptrs[4 * leaf + 0]);
  const float* g = reinterpret_cast<const float*>(ptrs[4 * leaf + 1]);
  float* m = reinterpret_cast<float*>(ptrs[4 * leaf + 2]);
  float* v = reinterpret_cast<float*>(ptrs[4 * leaf + 3]);
  const Scalars s{scal[0], scal[1], scal[2], scal[3], scal[4], wd[leaf]};

  long long i = start + threadIdx.x;
  const unsigned long long any =
      reinterpret_cast<unsigned long long>(p) | reinterpret_cast<unsigned long long>(g) |
      reinterpret_cast<unsigned long long>(m) | reinterpret_cast<unsigned long long>(v);
  if ((any & 15ull) == 0) {
    // chunk starts are multiples of 4 elements, so start is 16-byte aligned
    const long long vec_end = start + ((end - start) & ~3ll);
    for (long long j = start + 4ll * threadIdx.x; j < vec_end; j += 4ll * kThreads) {
      float4 pv = *reinterpret_cast<const float4*>(p + j);
      const float4 gv = *reinterpret_cast<const float4*>(g + j);
      float4 mv = *reinterpret_cast<const float4*>(m + j);
      float4 vv = *reinterpret_cast<const float4*>(v + j);
      adamw(pv.x, gv.x, mv.x, vv.x, h, s);
      adamw(pv.y, gv.y, mv.y, vv.y, h, s);
      adamw(pv.z, gv.z, mv.z, vv.z, h, s);
      adamw(pv.w, gv.w, mv.w, vv.w, h, s);
      *reinterpret_cast<float4*>(p + j) = pv;
      *reinterpret_cast<float4*>(m + j) = mv;
      *reinterpret_cast<float4*>(v + j) = vv;
    }
    i = vec_end + threadIdx.x;
  }
  for (; i < end; i += kThreads) {
    float pe = p[i], me = m[i], ve = v[i];
    adamw(pe, g[i], me, ve, h, s);
    p[i] = pe;
    m[i] = me;
    v[i] = ve;
  }
}

}  // namespace

// One AdamW step over every leaf in the tables; see adamw_multi_kernel.
// `chunk` must be a positive multiple of 4. Returns cudaGetLastError()
// after the launch (0 on success).
extern "C" int ecamp_adamw_multi(const void* ptrs, const void* numel, const void* wd,
                                 const void* chunk_leaf, const void* chunk_start, int n_chunks,
                                 const void* scal, long long chunk, float b1, float omb1,
                                 float b2, float omb2, float eps, void* stream) {
  if (n_chunks <= 0 || chunk <= 0 || chunk % 4 != 0) return (int)cudaErrorInvalidValue;
  const Hyper h{b1, omb1, b2, omb2, eps};
  adamw_multi_kernel<<<n_chunks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(ptrs), static_cast<const long long*>(numel),
      static_cast<const float*>(wd), static_cast<const int*>(chunk_leaf),
      static_cast<const long long*>(chunk_start), static_cast<const float*>(scal), chunk, h);
  return (int)cudaGetLastError();
}
