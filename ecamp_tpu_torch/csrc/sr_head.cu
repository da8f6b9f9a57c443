// SR head conv stack forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ecamp_tpu/kernels/sr_head.py::_sr_kernel (launched
// by _sr_conv_stack_impl): per image, channels-first,
//   out = relu(conv3x3(relu(conv3x3(x) + b1)) + b2 + x)
// with C = 3, zero padding, fp32 weights, every product and sum in fp32,
// conv1's output kept in fp32, the output rounded once to the input dtype.
//
// What bounds it on the H100: a 448^2 image is 1.2 MB in bf16, read once
// and written once, against 324 flops a pixel (two convs of 81 FMAs for
// the three channels): 27 flops a byte in bf16 and 13.5 in fp32, about the
// 20 flops a byte at which the fp32 FMA pipe (67 TFLOP/s) meets device
// memory (3.35 TB/s). So neither bytes nor FMAs may be wasted, and both
// bound it only once the stencil's neighbours come from shared memory.
//
// Two kernels, one picked by the caller from the input's layout
// (ecamp_tpu_torch/kernels/sr_head.py::sr_path):
//
// sr_conv_stack_tma_kernel (16-byte aligned x with 16-byte rows, the
// model's 448^2 shape): a persistent grid walks (image, 28-row tile,
// 112-column tile) items, 224 threads a block, two blocks an SM. Each
// item's input arrives by one TMA box of 3 x 32 x 128 through a 3-D tensor
// map over x as (W, H, N*3): the map's zero fill past the image's end is
// conv2's and conv1's zero padding there, and a box never reaches the next
// image (the first row and column of tiles, whose box would start at a
// negative coordinate, take theirs from 0: see the kernel). Two buffers,
// one mbarrier each: the next item's box is in flight while this one is
// computed. conv1 + relu fills an fp32 ring of 30 x 114 points (zeroed
// outside the image, as the Pallas kernel does at sr_head.py:63-65,
// because conv2 zero-pads its input) in shared memory; conv2 + b2 + the
// residual from the staged input + relu is stored from registers, two
// bf16 (or fp32) a store. Both convs run one register-blocked stencil: a
// thread computes two columns of all three channels down 7 rows, each
// input row loaded once into registers and used by the three output rows
// it touches, so every 4 values loaded feed 54 FMAs. The 168 parameters
// are copied to __constant__ memory on the call's stream before the
// launch; each phase takes its conv's 84 into registers once, so no row
// of the stencil loads a weight (the SASS loads them from the constant
// bank among the phase's first row of FFMAs and never after).
//
// sr_conv_stack_kernel (the generic path: unaligned x, or rows that are
// not a multiple of 16 bytes): one block stages its 16 x 64 tile with a
// 2-pixel halo in shared memory once, computes conv1 + relu on the +1 ring
// into a second shared tile, and conv2 + residual + relu from there. Grid:
// x = 64-column tiles, y = 16-row tiles, z = images; 256 threads a block.
// Weights are OIHW (the port's conv parameters), packed with the biases
// into one fp32 device buffer [w1 (81), b1 (3), w2 (81), b2 (3)] that each
// block copies into shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// the TMA kernel

namespace tma {

constexpr int kTH = 28;                  // output rows of an item
constexpr int kTW = 112;                 // output columns of an item
constexpr int kS = 7;                    // rows a thread computes, top to bottom
constexpr int kRH = kTH + 2;             // the conv1 ring
constexpr int kRW = kTW + 2;
constexpr int kRing = kRH * kRW;         // one channel of the ring
constexpr int kPairs = kTW / 2;          // threads across (two columns each)
constexpr int kSegs = kTH / kS;
constexpr int kThreads = kPairs * kSegs;  // whole warps: a partial one holds registers too
// the ring's outer points: its top and bottom rows and its last column
// pair, one row of a column pair a thread
constexpr int kRingPairs = kRW / 2;
constexpr int kOuter = 2 * kRingPairs + kTH;
constexpr int kLeft = 8;                 // box columns left of the tile
constexpr int kBoxW = 128;               // kLeft + kTW + 2, rounded up to 16 bytes
constexpr int kBoxH = kTH + 4;
constexpr int kBox = kBoxH * kBoxW;      // one channel of a box
constexpr int kSlack = 3 * kBoxW;        // before each box: what an edge item reads and drops
static_assert(kTH % kS == 0 && kTW % 2 == 0 && kThreads % 32 == 0 && kOuter <= kThreads,
              "tile");
static_assert(kBoxW >= kLeft + kTW + 2 && kBoxW % 8 == 0, "box");

template <typename T>
__host__ __device__ constexpr int box_bytes() {
  return kC * kBox * (int)sizeof(T);
}
template <typename T>
__host__ __device__ constexpr int buffer_bytes() {  // slack and box; both 128-byte multiples
  return kSlack * (int)sizeof(T) + box_bytes<T>();
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return 2 * buffer_bytes<T>() + kC * kRing * 4 + 2 * 8;
}

// the two convs' [w (81, OIHW), b (3)], set on the call's stream before
// its launch: each FFMA of the stencil reads its weight from the constant
// bank
__constant__ float c_params[2][kW + kC];

// four consecutive values from shared memory, as fp32: two 8-byte loads
// (fp32) or two 4-byte loads (bf16); p is aligned to match
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 2);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const unsigned a = *reinterpret_cast<const unsigned*>(p);
  const unsigned b = *reinterpret_cast<const unsigned*>(p + 2);
  v[0] = __uint_as_float(a << 16);
  v[1] = __uint_as_float(a & 0xffff0000u);
  v[2] = __uint_as_float(b << 16);
  v[3] = __uint_as_float(b & 0xffff0000u);
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// conv kConv's weights and biases from the constant bank into registers
// for the phase; the empty asm keeps the front end from moving each load
// to its uses in the stencil's rows
template <int kConv>
__device__ __forceinline__ void load_weights(float (&w)[kW + kC]) {
#pragma unroll
  for (int i = 0; i < kW + kC; ++i) {
    w[i] = c_params[kConv][i];
    asm volatile("" : "+f"(w[i]));
  }
}

// every product of acc computed here: a row's sums are then not moved
// into the branches that use them, where each would run as one chain of
// dependent FFMAs
__device__ __forceinline__ void settle(float (&acc)[kC][2]) {
#pragma unroll
  for (int co = 0; co < kC; ++co) asm volatile("" : "+f"(acc[co][0]), "+f"(acc[co][1]));
}

// the conv of weights w of kRows consecutive rows at two neighbouring
// columns, all three output channels: p is the source at (channel 0, the first input
// row, the first of the four input columns), `pitch` its row and `plane`
// its channel stride. Input row r is loaded once, when output row r - 2
// is due; emit(row, acc) takes each output row's acc[co][column]. Where
// the source holds no zero padding, zero_row0 zeroes the first input row
// and zero_col1 the second input column, as they are loaded.
template <int kRows, typename S, typename Emit>
__device__ __forceinline__ void stencil(const float (&w)[kW + kC], const S* p, int pitch,
                                        int plane, bool zero_row0, bool zero_col1, Emit emit) {
  float v[kRows + 2][kC][4];
#pragma unroll
  for (int r = 0; r < kRows + 2; ++r) {
#pragma unroll
    for (int ci = 0; ci < kC; ++ci) {
      load4(p + ci * plane + r * pitch, v[r][ci]);
      if (zero_col1) v[r][ci][1] = 0.f;
      if (r == 0 && zero_row0) v[r][ci][0] = v[r][ci][1] = v[r][ci][2] = v[r][ci][3] = 0.f;
    }
    if (r >= 2) {
      float acc[kC][2];
#pragma unroll
      for (int co = 0; co < kC; ++co) acc[co][0] = acc[co][1] = w[kW + co];
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int ci = 0; ci < kC; ++ci)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx)
#pragma unroll
            for (int co = 0; co < kC; ++co)
#pragma unroll
              for (int j = 0; j < 2; ++j)
                acc[co][j] = fmaf(w[widx(co, ci, dy, dx)], v[r - 2 + dy][ci][j + dx], acc[co][j]);
      settle(acc);
      emit(r - 2, acc);
    }
  }
}

}  // namespace tma

// Item i is (image, row tile, column tile) = (i / (ty tx), i / tx % ty,
// i % tx); block b takes items b, b + grid, ... Shared memory: two buffers
// of kSlack values and a box of (3, kBoxH, kBoxW) in T, where box point
// (iy, ix) is image pixel (row0 - 2 + iy, col0 - kLeft + ix); the fp32 ring
// (3, kRH, kRW), where ring point (ry, rx) is pixel (row0 - 1 + ry,
// col0 - 1 + rx); the two mbarriers. Ring point (ry, rx) reads box rows
// ry .. ry + 2 and columns rx + kLeft - 2 .. rx + kLeft, so a ring column
// pair from an even rx starts at an even box column (4-byte bf16 loads,
// 8-byte fp32 loads); output (oy, ox) reads ring rows oy .. oy + 2,
// columns ox .. ox + 2, and its residual at box (oy + 2, ox + kLeft).
//
// TMA is given no negative coordinate (on the H100 such a load stopped the
// kernel with an illegal instruction): an item of the first row or column
// of tiles has its box loaded from row or column 0, kLeft columns or 2
// rows later than the layout above, and reads it from that much earlier,
// so its image row -2 and -1 or column -2 and -1 read other values of the
// buffer or its slack. Of those, image row -1 and column -1 reach a ring
// point inside the image only as the first box row read for ring row 1 and
// the second box column read for ring columns 0 and 1, and the stencil
// zeroes them there; the rest reach only ring points outside the image,
// which are zeroed (by a select, so a NaN there is dropped too).
template <typename T>
__global__ void __launch_bounds__(tma::kThreads, 2)
sr_conv_stack_tma_kernel(const __grid_constant__ CUtensorMap xmap, T* __restrict__ out, int H,
                         int W, int tiles_y, int tiles_x, int items) {
  using namespace tma;
  extern __shared__ __align__(128) unsigned char smem[];
  float* const ring = reinterpret_cast<float*>(smem + 2 * buffer_bytes<T>());
  uint64_t* const full = reinterpret_cast<uint64_t*>(ring + kC * kRing);
  auto box = [&](int b) { return reinterpret_cast<T*>(smem + b * buffer_bytes<T>()) + kSlack; };

  const int tid = threadIdx.x;
  const long long plane = (long long)H * W;

  auto load = [&](int item, int b) {
    const int tx = item % tiles_x;
    const int ty = item / tiles_x % tiles_y;
    const int img = item / tiles_x / tiles_y;
    hopper::mbar_expect_tx(&full[b], box_bytes<T>());
    hopper::tma_load_3d(box(b), &xmap, &full[b], tx > 0 ? tx * kTW - kLeft : 0,
                        ty > 0 ? ty * kTH - 2 : 0, img * kC);
  };

  if (tid == 0) {
    hopper::mbar_init(&full[0], 1);
    hopper::mbar_init(&full[1], 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    for (int b = 0; b < 2; ++b)
      if (blockIdx.x + b * gridDim.x < items) load(blockIdx.x + b * gridDim.x, b);
  }

  int k = 0;
  for (int item = blockIdx.x; item < items; item += gridDim.x, ++k) {
    const int b = k & 1;
    const int tx = item % tiles_x;
    const int ty = item / tiles_x % tiles_y;
    const int img = item / tiles_x / tiles_y;
    const int row0 = ty * kTH, col0 = tx * kTW;
    // the box in the layout above (see the edge items' note)
    const T* const x = box(b) - (ty == 0 ? 2 * kBoxW : 0) - (tx == 0 ? kLeft : 0);
    hopper::mbar_wait(&full[b], (k >> 1) & 1);

    // conv1 + b1, relu, zero outside the image, into the ring at (ry, rx .. rx + 1)
    auto to_ring = [&](int ry, int rx, float (&acc)[kC][2]) {
      const int gr = row0 - 1 + ry, gc = col0 - 1 + rx;
      const bool row_in = gr >= 0 && gr < H;
      const bool in0 = row_in && gc >= 0 && gc < W, in1 = row_in && gc + 1 < W;
#pragma unroll
      for (int co = 0; co < kC; ++co)
        *reinterpret_cast<float2*>(ring + co * kRing + ry * kRW + rx) =
            make_float2(in0 ? fmaxf(acc[co][0], 0.f) : 0.f, in1 ? fmaxf(acc[co][1], 0.f) : 0.f);
    };
    {
      float w[kW + kC];
      load_weights<0>(w);
      {  // ring rows 1 .. kTH, columns 0 .. kTW - 1: row segment seg, column pair `pair`
        const int pair = tid % kPairs, seg = tid / kPairs;
        const int ry0 = 1 + seg * kS, rx0 = 2 * pair;
        stencil<kS>(w, x + ry0 * kBoxW + rx0 + kLeft - 2, kBoxW, kBox, seg == 0 && ty == 0,
                    pair == 0 && tx == 0,
                    [&](int r, float(&acc)[kC][2]) { to_ring(ry0 + r, rx0, acc); });
      }
      if (tid < kOuter) {  // ring rows 0 and kRH - 1, then columns kTW, kTW + 1
        const bool row = tid < 2 * kRingPairs;
        const int ry = row ? (tid < kRingPairs ? 0 : kRH - 1) : 1 + tid - 2 * kRingPairs;
        const int rx0 = row ? 2 * (tid % kRingPairs) : kTW;
        stencil<1>(w, x + ry * kBoxW + rx0 + kLeft - 2, kBoxW, kBox, ry == 1 && ty == 0,
                   rx0 == 0 && tx == 0,
                   [&](int, float(&acc)[kC][2]) { to_ring(ry, rx0, acc); });
      }
    }
    __syncthreads();

    {  // conv2 + b2 + the residual, relu, rounded once, stored
      const int pair = tid % kPairs, seg = tid / kPairs;
      const int oy0 = seg * kS, ox = 2 * pair;
      const int gc = col0 + ox;
      // output (channel 0, row oy0, column ox) of this item
      T* const o0 = out + img * kC * plane + (long long)(row0 + oy0) * W + gc;
      float w[kW + kC];
      load_weights<1>(w);
      stencil<kS>(w, ring + oy0 * kRW + ox, kRW, kRing, false, false,
                  [&](int r, float(&acc)[kC][2]) {
        if (row0 + oy0 + r >= H || gc >= W) return;
#pragma unroll
        for (int co = 0; co < kC; ++co) {
          float res[4];  // box columns ox + kLeft .. ox + kLeft + 3
          load4(x + co * kBox + (oy0 + r + 2) * kBoxW + ox + kLeft, res);
          const float a = fmaxf(acc[co][0] + res[0], 0.f);
          const float c = fmaxf(acc[co][1] + res[1], 0.f);
          T* const o = o0 + co * plane + r * (long long)W;
          if (gc + 1 < W)
            store2(o, a, c);
          else
            o[0] = from_f<T>(a);
        }
      });
    }
    __syncthreads();  // the ring and this box are free again
    if (tid == 0 && item + 2 * gridDim.x < items) load(item + 2 * gridDim.x, b);
  }
}

template <typename T>
int launch_tma(const void* x, const void* params, void* out, int N, int H, int W,
               CUtensorMapDataType type, cudaStream_t stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) return (int)cudaErrorInvalidValue;
  const int tiles_y = (H + tma::kTH - 1) / tma::kTH, tiles_x = (W + tma::kTW - 1) / tma::kTW;
  const long long items = (long long)N * tiles_y * tiles_x;
  if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!hopper::plain_map_3d(&map, x, type, sizeof(T), (long long)N * kC, H, W, kC, tma::kBoxH,
                            tma::kBoxW))
    return (int)cudaErrorInvalidValue;
  auto kernel = sr_conv_stack_tma_kernel<T>;
  constexpr int smem = tma::smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, tma::kThreads, smem);
  if (err != cudaSuccess) return (int)err;
  const long long slots = (long long)hopper::sm_count() * per_sm;
  if (slots <= 0) return (int)cudaErrorInvalidDevice;
  err = cudaMemcpyToSymbolAsync(tma::c_params, params, sizeof(tma::c_params), 0,
                                cudaMemcpyDeviceToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)(items < slots ? items : slots), tma::kThreads, smem, stream>>>(
      map, static_cast<T*>(out), H, W, tiles_y, tiles_x, (int)items);
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

// The same for the TMA kernel, which needs x and out 16-byte aligned and
// W * itemsize a multiple of 16 (cudaErrorInvalidValue otherwise; the
// caller picks the kernel, sr_head.py::sr_path). The parameters are copied
// to the kernel's constant bank on `stream` before the launch, so two
// streams that run it at once with different weights would share them.
extern "C" int ecamp_sr_conv_stack_fwd_tma(const void* x, const void* params, void* out, int N,
                                           int H, int W, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_tma<float>(x, params, out, N, H, W, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, s);
  if (dtype == 1)
    return launch_tma<__nv_bfloat16>(x, params, out, N, H, W, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                     s);
  return (int)cudaErrorInvalidValue;
}
