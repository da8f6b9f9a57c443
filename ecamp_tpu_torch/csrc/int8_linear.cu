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
// What bounds it on the H100: at bucket 64's M = 12,608 the tensor cores
// (2·M·N·K operations), and beside them the widening, a handful of
// instructions a weight for every tile of tokens; at serving's M = 197 rows
// an image the few tiles there are to spread over 132 SMs, each walking the
// whole K, and the loads' latency.
//
// What the design does about it. One TMA + wgmma mainloop computes yᵀ
// tiles of 128 output channels by BT tokens (BT = 128 or 256): one
// producer thread keeps a ring of stages in flight behind mbarriers, each
// a BT x 64 bf16 x box (128-byte swizzle) and a 128 x 64 int8 q box
// (64-byte swizzle); each of two consumer warpgroups owns 64 channels and
// runs wgmma m64nBTk16 with A = its weight rows from registers and B = the
// x tile from shared memory. So the weight is widened straight into wgmma's
// A fragments, once a stage for BT tokens, and never goes back to shared
// memory; a thread's fragment holds two rows, so it loads their two scales
// (and biases) once a tile. The other layout, x as A and the weight
// widened once a stage into a shared bf16 tile, measured 22-33% of the
// bound at M = 12,608 on the H100: the tile's round trip through shared
// memory and the barrier between the warpgroups that it needs left the
// tensor cores idle. Here a warpgroup widens stage k + 1 into a second set
// of fragment registers while its stage-k wgmmas run, and the two
// warpgroups share no buffer and never wait for each other.
// A thread reads its bytes 2t, 2t + 1, 8 + 2t, 9 + 2t (t = lane % 4) of
// each 16 of a row as two 32-bit shared loads that the 64-byte swizzle
// keeps free of bank conflicts, and one byte permute joins them. The
// widening of a byte q is exact and short: q ^ 0x80 put by a byte permute
// into the low byte of the fp32 0x4B000000 is 2^23 + q + 128, one subtract
// gives float(q), one multiply by s[n] rounds to fp32 and one
// cvt.rn.bf16x2 packs two: the plain version's `bf16(float(q) · s)` bit for
// bit.
// The grid is persistent, over work units. A unit is a tile or, where the
// tiles are too few to fill the card (serving's M = 197) or the last wave
// of tiles would leave SMs idle, a split of a tile's K in whole 64-deep
// stages, the splits spread as evenly as they go
// (kernels/int8_linear.py::_plan picks BT and the units from a cost model
// fitted on the card). A tile of one unit gets the bias in fp32 and is
// rounded once to bf16 in the epilogue; split units write fp32 partials
// into a workspace the wrapper allocates, and a second launch sums each
// element's partials in split order, adds the bias and rounds once:
// deterministic, no atomics. The epilogue transposes each warpgroup's 64 x
// BT accumulators through its own shared memory into rows of y, stored by
// TMA while the warpgroup goes on to its next unit (16-byte stores for
// partials and for rows that are not 16-byte aligned).
// TMA's zero fill takes the ragged M, N and K edges. The tensor maps are
// encoded once for each address and shape (a host cache, `cached_map`):
// once a weight, and for x and y once for each buffer the allocator hands
// out.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <functional>
#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace {

using namespace hopper;
using bf16 = __nv_bfloat16;

constexpr int kBN = 128;        // output channels a tile: 64 a consumer warpgroup
constexpr int kBK = 64;         // depth of a stage: one 128-byte swizzle row of bf16
constexpr int kThreads = 384;   // two consumer warpgroups and a producer warpgroup
constexpr int kConsumers = 256;
constexpr int kQBytes = kBN * kBK;  // one q box, 8 KB

template <int BT>
struct Layout {
  static constexpr int kStages = BT == 128 ? 8 : 4;  // ring depth: all shared memory holds
  static constexpr int kXBytes = BT * kBK * 2;       // one x box
  static constexpr int kStage = kXBytes + kQBytes;   // a multiple of 1024
  static constexpr int kOut = 64 * BT * 2;           // a warpgroup's bf16 yᵀ tile
  static constexpr int kSmem = kStages * kStage + 2 * kOut + 1024;  // + alignment
};

// What the kernel computes and how it is cut. Tiles are numbered row of
// tiles by row of tiles. The first `whole` are a unit each; the rest, the
// tail, are cut into the other units - whole >= tail - whole units, tile
// `whole + i` into base + 1 splits if i < extra, base otherwise (base, extra
// = (units - whole) / (tiles - whole) and its remainder), each a whole number
// of stages. A split tail (units > tiles) goes through fp32 partials over
// rows row0 .. M - 1, row0 the first row of the first tail tile's row.
struct Work {
  int M, N, K;
  int nk;        // stages of K
  int tiles_n;   // tiles along N
  int tiles;     // tiles in all
  int whole;     // tiles of one unit
  int units;     // work units
  int row0;      // the partials' first row
  int tma_y;     // y's rows are 16-byte aligned (N % 8 == 0): stored by TMA
};

// unit u's tile t, its split among n_splits and its stages k0 .. k1 - 1
__device__ __forceinline__ void unit_of(const Work& w, int u, int& t, int& split, int& k0,
                                        int& k1) {
  if (u < w.whole) {
    t = u;
    split = 0;
    k0 = 0;
    k1 = w.nk;
    return;
  }
  u -= w.whole;
  const int tail = w.tiles - w.whole, tail_units = w.units - w.whole;
  const int base = tail_units / tail, extra = tail_units % tail;
  const int big = extra * (base + 1);  // the units of the tiles cut base + 1 ways
  int n;
  if (u < big) {
    n = base + 1;
    t = u / n;
    split = u % n;
  } else {
    n = base;
    t = extra + (u - big) / n;
    split = (u - big) % n;
  }
  t += w.whole;
  k0 = split * w.nk / n;
  k1 = (split + 1) * w.nk / n;
}

// a consumer warpgroup's own barrier (ids 2, 3; the producer never joins)
__device__ __forceinline__ void warpgroup_sync(int wgi) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wgi) : "memory");
}

template <int BT>
__device__ __forceinline__ void wgmma_rs(float (&d)[BT / 2], const unsigned (&a)[4],
                                         uint64_t db) {
  static_assert(BT == 128 || BT == 256, "the two token tiles");
  if constexpr (BT == 128)
    wgmma_m64n128_rs<0>(d, a, db);
  else
    wgmma_m64n256_rs<0>(d, a, db);
}

constexpr float kMagic = 8388736.f;  // 2^23 + 128

// float(q) of byte j of w, where w holds each byte q as q ^ 0x80
__device__ __forceinline__ float byte_float(unsigned w, unsigned j) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440u | j)), kMagic);
}

// bf16(float(q) · s) of bytes j, j + 1 of w, packed low to high
__device__ __forceinline__ unsigned widen2(unsigned w, unsigned j, float s) {
  const __nv_bfloat162 h =
      __floats2bfloat162_rn(__fmul_rn(byte_float(w, j), s), __fmul_rn(byte_float(w, j + 1), s));
  return *reinterpret_cast<const unsigned*>(&h);
}

// A fragments of one stage, a[step][i] for 4 wgmma steps of 16 k, from the
// q box `qs` (128 rows of 64 bytes, 16-byte chunk c of row r at c ^ ((r /
// 2) % 4)). Register i of a step holds k 2t, 2t + 1 (i = 0, 1) or 8 + 2t,
// 9 + 2t (i = 2, 3) of the step's 16, of row r0 (i even) or r0 + 8 (i
// odd), t = lane % 4: two words of the row's chunk, half of each.
__device__ __forceinline__ void widen_stage(const unsigned char* qs, int r0, int t,
                                            const float (&sc)[2], unsigned (&a)[kBK / 16][4]) {
  const unsigned sel = (t & 1) ? 0x7632u : 0x5410u;  // the high or low halves
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    const unsigned char* row = qs + r * kBK + 4 * (t >> 1);
    const int sw = (r >> 1) & 3;
#pragma unroll
    for (int j = 0; j < kBK / 16; ++j) {
      const unsigned char* chunk = row + 16 * (j ^ sw);
      const unsigned lo = *reinterpret_cast<const unsigned*>(chunk);
      const unsigned hi = *reinterpret_cast<const unsigned*>(chunk + 8);
      const unsigned v = __byte_perm(lo, hi, sel) ^ 0x80808080u;
      a[j][h] = widen2(v, 0, sc[h]);
      a[j][2 + h] = widen2(v, 2, sc[h]);
    }
  }
}

// The epilogue of a warpgroup's 64 x BT accumulators (channels x tokens):
// y = acc + bias rounded once (T = bf16), or acc into a split's fp32
// partials (T = float), transposed through the warpgroup's shared memory
// `st` in passes of P tokens. Accumulator fragment i of a thread: channel
// 16 warp + lane/4 + 8 ((i / 2) % 2), token 8 (i / 4) + 2 (lane % 4) + i % 2.
// Lanes lane and lane ^ 4 trade one value of each pair, so that a thread
// holds two neighbouring channels of one token; a token's 64 channels are
// a row of `st` (16-byte chunk c at c ^ (token % 8): no bank conflicts,
// and for bf16 the 128-byte swizzle of y's TMA map). With `ty`, one thread
// stores the tile by TMA and the warpgroup goes on to its next unit while
// the store runs (every epilogue first waits for it to have read `st`);
// else rows go out in 16-byte stores, neighbouring threads on neighbouring
// chunks, row m of the tile to row m - row0 of `out`. bias_h: the bias of
// the thread's two channels (0 for partials).
template <int BT, typename T>
__device__ __forceinline__ void store_tile(const float (&acc)[BT / 2], const Work& w, int m0,
                                           int n0, int wgi, const float (&bias_h)[2], T* out,
                                           int row0, const CUtensorMap* ty, unsigned char* st) {
  constexpr int kSize = (int)sizeof(T);
  constexpr int P = BT * 2 / kSize;   // tokens a pass: P rows of 64 fill the bf16 tile
  constexpr int kRow = 64 * kSize;    // bytes of a row of st
  constexpr int kEl = 16 / kSize;     // elements a chunk
  constexpr int kChunks = 64 / kEl;   // chunks a row
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const bool odd = g & 1;
  const int ch0 = n0 + wgi * 64;  // the warpgroup's first channel
  const bool vec = (w.N * kSize) % 16 == 0;  // 16-byte aligned rows of out
  if (tid == 0) bulk_wait();  // the last TMA store from st has read it
  warpgroup_sync(wgi);
#pragma unroll
  for (int pass = 0; pass < BT / P; ++pass) {
#pragma unroll
    for (int jj = 0; jj < P / 8; ++jj) {
      const int j = pass * P / 8 + jj;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float v0 = acc[4 * j + 2 * h] + bias_h[h];
        const float v1 = acc[4 * j + 2 * h + 1] + bias_h[h];
        // even g keeps token 2t (its channel and the next), odd g token 2t + 1
        const float got = __shfl_xor_sync(0xffffffffu, odd ? v0 : v1, 4);
        const float lo = odd ? got : v0, hi = odd ? v1 : got;
        const int tok = 8 * jj + 2 * t + (odd ? 1 : 0);  // token in the pass
        const int c = warp * 16 + 8 * h + (g & ~1);      // channel in the warpgroup
        unsigned char* at = st + tok * kRow + 16 * ((c / kEl) ^ (tok & 7)) + (c % kEl) * kSize;
        if constexpr (kSize == 2)
          *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(lo, hi);
        else
          *reinterpret_cast<float2*>(at) = make_float2(lo, hi);
      }
    }
    if (ty != nullptr) {
      async_proxy_fence();
      warpgroup_sync(wgi);
      if (tid == 0) {
        tma_store(ty, st, ch0, m0 + pass * P);
        bulk_commit();
      }
      continue;
    }
    warpgroup_sync(wgi);
    for (int i = tid; i < P * kChunks; i += 128) {
      const int tok = i / kChunks, ch = i % kChunks;
      const long long m = m0 + pass * P + tok;
      const int n = ch0 + ch * kEl;
      if (m >= w.M || n >= w.N) continue;
      const uint4 v = *reinterpret_cast<const uint4*>(st + tok * kRow + 16 * (ch ^ (tok & 7)));
      T* o = out + (m - row0) * w.N + n;
      if (vec && n + kEl <= w.N) {
        *reinterpret_cast<uint4*>(o) = v;
      } else {
        const T* e = reinterpret_cast<const T*>(&v);
        for (int k = 0; k < kEl && n + k < w.N; ++k) o[k] = e[k];
      }
    }
    warpgroup_sync(wgi);  // the pass is out: its shared memory is free
  }
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
int8_linear_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap ty, const float* __restrict__ scale,
                   const bf16* __restrict__ bias, bf16* __restrict__ y, float* __restrict__ part,
                   const Work w) {
  using L = Layout<BT>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  // the swizzle patterns repeat every 1024 bytes: stages start on it
  unsigned char* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  const int wgi = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wgi == 2) {  // producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      prefetch_map(&tx);
      prefetch_map(&tq);
      int s = 0;
      unsigned ph = 0;
      for (int u = blockIdx.x; u < w.units; u += gridDim.x) {
        int t, split, k0, k1;
        unit_of(w, u, t, split, k0, k1);
        const int m0 = t / w.tiles_n * BT, n0 = t % w.tiles_n * kBN;
        for (int kt = k0; kt < k1; ++kt) {
          mbar_wait(&empty[s], ph ^ 1);
          mbar_expect_tx(&full[s], L::kStage);
          unsigned char* st = smem + s * L::kStage;
          tma_load(st, &tx, &full[s], kt * kBK, m0);
          tma_load(st + L::kXBytes, &tq, &full[s], kt * kBK, n0);
          if (++s == kStages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
    }
  } else {  // consumers: warpgroup wgi owns channels 64 wgi .. 64 wgi + 63 of a tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int lane = threadIdx.x % 32, t = lane % 4;
    const int r0 = wgi * 64 + (threadIdx.x % 128) / 32 * 16 + lane / 4;  // row in the q box
    unsigned char* out = smem + kStages * L::kStage + wgi * L::kOut;
    const bool split_k = w.units > w.tiles;  // the tail's units write partials
    float acc[BT / 2];
    unsigned a0[kBK / 16][4], a1[kBK / 16][4];  // one stage's A fragments, two stages
    int s = 0;
    unsigned ph = 0;
    // Stage kt's wgmmas read fragments `cur` while stage kt + 1 is widened
    // into `nxt`; returns whether there was a stage kt + 1.
    auto step = [&](int kt, int k1, unsigned (&cur)[kBK / 16][4], unsigned (&nxt)[kBK / 16][4],
                    const float (&sc)[2]) {
      const bool more = kt + 1 < k1;
      const int sn = s + 1 == kStages ? 0 : s + 1;
      const unsigned phn = s + 1 == kStages ? ph ^ 1 : ph;
      if (more) mbar_wait(&full[sn], phn);  // before the fence: no spin among the wgmmas
      const unsigned char* st = smem + s * L::kStage;
      wg_fence();
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j)
        wgmma_rs<BT>(acc, cur[j], sw128_desc(st + j * 32, 16, 1024));
      wg_commit();
      if (more) widen_stage(smem + sn * L::kStage + L::kXBytes, r0, t, sc, nxt);
      wg_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int j = 0; j < kBK / 16; ++j) fence_regs(cur[j]);  // read until the wait
      mbar_arrive(&empty[s]);
      s = sn;
      ph = phn;
      return more;
    };
    for (int u = blockIdx.x; u < w.units; u += gridDim.x) {
      int tile, split, k0, k1;
      unit_of(w, u, tile, split, k0, k1);
      const int m0 = tile / w.tiles_n * BT, n0 = tile % w.tiles_n * kBN;
      const bool partial = split_k && tile >= w.whole;
      float sc[2], bias_h[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + r0 + 8 * h;
        sc[h] = n < w.N ? scale[n] : 0.f;
        bias_h[h] = !partial && bias != nullptr && n < w.N ? __bfloat162float(bias[n]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) acc[i] = 0.f;
      fence_regs(acc);
      mbar_wait(&full[s], ph);
      widen_stage(smem + s * L::kStage + L::kXBytes, r0, t, sc, a0);
      for (int kt = k0; step(kt, k1, a0, a1, sc) && step(kt + 1, k1, a1, a0, sc); kt += 2) {
      }
      if (partial)
        store_tile<BT, float>(acc, w, m0, n0, wgi, bias_h,
                              part + (long long)split * (w.M - w.row0) * w.N, w.row0, nullptr,
                              out);
      else
        store_tile<BT, bf16>(acc, w, m0, n0, wgi, bias_h, y, 0, w.tma_y ? &ty : nullptr, out);
    }
    if (threadIdx.x % 128 == 0) bulk_wait<true>();  // the last TMA store is done
  }
}

// y = the sum of each element's split partials in split order + bias,
// rounded once, for the tail tiles: tail tile whole + i has base + (i <
// extra) splits. Block (x, r) takes row row0 + r, 4 columns a thread;
// elements of whole tiles in that row are already in y.
constexpr int kReduceThreads = 128;

__global__ void __launch_bounds__(kReduceThreads)
int8_linear_reduce_kernel(const float* __restrict__ part, const bf16* __restrict__ bias,
                          bf16* __restrict__ y, int M, int N, int bt, int tiles_n, int whole,
                          int row0, int base, int extra) {
  const int m = row0 + blockIdx.y;
  const int n = (blockIdx.x * kReduceThreads + threadIdx.x) * 4;
  if (n >= N) return;
  const int row_tail = m / bt * tiles_n - whole;  // the tail index of the row's first tile
  const long long plane = (long long)(M - row0) * N;
  const float* p = part + (long long)blockIdx.y * N + n;
  bf16* o = y + (long long)m * N + n;
  if (N % 4 == 0) {  // 16-byte partials, 8-byte outputs; a 4-column group is in one tile
    const int i = row_tail + n / kBN;
    if (i < 0) return;  // a whole tile
    const int splits = base + (i < extra);
    float4 v = *reinterpret_cast<const float4*>(p);
    for (int i = 1; i < splits; ++i) {
      const float4 e = *reinterpret_cast<const float4*>(p + i * plane);
      v.x += e.x;
      v.y += e.y;
      v.z += e.z;
      v.w += e.w;
    }
    if (bias != nullptr) {
      v.x += __bfloat162float(bias[n]);
      v.y += __bfloat162float(bias[n + 1]);
      v.z += __bfloat162float(bias[n + 2]);
      v.w += __bfloat162float(bias[n + 3]);
    }
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    *reinterpret_cast<uint2*>(o) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                              *reinterpret_cast<const unsigned*>(&hi));
    return;
  }
  for (int c = 0; c < 4 && n + c < N; ++c) {
    const int i = row_tail + (n + c) / kBN;
    if (i < 0) continue;  // a whole tile
    const int splits = base + (i < extra);
    float v = p[c];
    for (int i = 1; i < splits; ++i) v += p[c + i * plane];
    if (bias != nullptr) v += __bfloat162float(bias[n + c]);
    o[c] = __float2bfloat16(v);
  }
}

// A tensor map, encoded once for each (kind, address, shape, box): a map
// holds nothing else, so a hit is the map a new encoding would give. The
// weights' maps are made once a weight; x's and y's hit whenever the
// caching allocator hands a call the buffers of an earlier one, as a
// server's forward of a bucket does. Kinds: 0 = int8 q (box 128 rows),
// 1 = bf16 x or y (box `box` rows).
struct MapKey {
  const void* p;
  int kind, rows, cols, box;
  bool operator==(const MapKey& o) const {
    return p == o.p && kind == o.kind && rows == o.rows && cols == o.cols && box == o.box;
  }
};

struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = std::hash<const void*>()(k.p);
    for (const int v : {k.kind, k.rows, k.cols, k.box}) h = h * 1000003u ^ (size_t)v;
    return h;
  }
};

constexpr size_t kMapCache = 4096;  // entries kept before the cache starts again

bool cached_map(CUtensorMap* out, int kind, const void* p, int rows, int cols, int box) {
  static std::mutex mu;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  const MapKey key{p, kind, rows, cols, box};
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *out = hit->second;
    return true;
  }
  const bool ok = kind == 0 ? u8_map(out, p, rows, cols, box)
                            : bf16_map(out, p, rows, cols, cols, box);
  if (!ok) return false;
  if (cache.size() >= kMapCache) cache.clear();
  cache.emplace(key, *out);
  return true;
}

template <int BT>
int launch(const void* x, const void* q, const void* s, const void* b, void* y, void* part,
           const Work& w, int grid, cudaStream_t st) {
  CUtensorMap tx, tq, ty;
  if (!cached_map(&tx, 1, x, w.M, w.K, BT) || !cached_map(&tq, 0, q, w.N, w.K, kBN))
    return (int)cudaErrorInvalidValue;
  if (!w.tma_y) {
    ty = tx;  // not read
  } else if (!cached_map(&ty, 1, y, w.M, w.N, BT)) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  static bool smem_set[64] = {};
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!smem_set[dev]) {  // above 48 KB: once a device
    err = cudaFuncSetAttribute(int8_linear_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Layout<BT>::kSmem);
    if (err != cudaSuccess) return (int)err;
    smem_set[dev] = true;
  }
  int8_linear_kernel<BT><<<grid, kThreads, Layout<BT>::kSmem, st>>>(
      tx, tq, ty, static_cast<const float*>(s), static_cast<const bf16*>(b),
      static_cast<bf16*>(y), static_cast<float*>(part), w);
  err = cudaGetLastError();
  if (err != cudaSuccess || w.units == w.tiles) return (int)err;
  const int tail = w.tiles - w.whole, tail_units = w.units - w.whole;
  const dim3 blocks((w.N + 4 * kReduceThreads - 1) / (4 * kReduceThreads), w.M - w.row0);
  int8_linear_reduce_kernel<<<blocks, kReduceThreads, 0, st>>>(
      static_cast<const float*>(part), static_cast<const bf16*>(b), static_cast<bf16*>(y), w.M,
      w.N, BT, w.tiles_n, w.whole, w.row0, tail_units / tail, tail_units % tail);
  return (int)cudaGetLastError();
}

}  // namespace

// b may be null (no bias). M, N > 0, K > 0 a multiple of 16, x and q 16-byte
// aligned. The plan (kernels/int8_linear.py::_plan): bt tokens a tile (128
// or 256; 128 channels); the first `whole` tiles one unit each and the
// rest cut into units - whole units (more than the tiles: split-K, part an
// fp32 workspace of ceil((units - whole) / (tiles - whole)) x (M - row0) x
// N, row0 = whole / (tiles along N) * bt), on a persistent grid of `grid`
// blocks.
extern "C" int ecamp_int8_linear(const void* x, const void* q, const void* s, const void* b,
                                 void* y, void* part, int M, int N, int K, int bt, int whole,
                                 int units, int grid, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 16 != 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  if (((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(q)) & 15) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (bt != 128 && bt != 256) return (int)cudaErrorInvalidValue;
  Work w;
  w.M = M;
  w.N = N;
  w.K = K;
  w.nk = (K + kBK - 1) / kBK;
  w.tiles_n = (N + kBN - 1) / kBN;
  const long long tiles = (long long)((M + bt - 1) / bt) * w.tiles_n;
  if (whole < 0 || whole > tiles || tiles > units) return (int)cudaErrorInvalidValue;
  if (whole == tiles ? units != tiles : units - whole > (tiles - whole) * w.nk)
    return (int)cudaErrorInvalidValue;
  w.tiles = (int)tiles;
  w.whole = whole;
  w.units = units;
  w.row0 = whole / w.tiles_n * bt;
  // the partials, and the reduction's grid: a block a row
  if (units > w.tiles && (part == nullptr || M - w.row0 > 65535))
    return (int)cudaErrorInvalidValue;
  w.tma_y = N % 8 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bt == 128) return launch<128>(x, q, s, b, y, part, w, grid, st);
  return launch<256>(x, q, s, b, y, part, w, grid, st);
}
