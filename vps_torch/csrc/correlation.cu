// Correlation cost volume, forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vps_tpu/ops/correlation.py:_corr_kernel
// (launched by _correlation_pallas_2d). The same function:
//
//   out[b, y, x, k] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
//
// for the k-th displacement (dy, dx) in {-md .. md step s2}^2, row-major with
// dy outer; f2 reads zero outside the map; accumulation in f32; the output is
// channel-last (B, H, W, D^2) in the input dtype. One kernel serves every
// stride, batch and channel count (FlowNetC: md 20, s2 2, 441 channels;
// LiteFlowNetCorr: md 4, s2 1, 81 channels).
//
// What bounds it on an H100: bytes. Counting each input byte read once and
// each output byte written once, LiteFlowNetCorr at 1024x2048 (256x512x256
// bf16 maps -> 81 channels) moves ~155 MB, ~46 us at 3.35 TB/s, while its
// 5.4 GFLOP take ~5.5 us at the 989 TF/s bf16 peak; FlowNetC at half-flow
// (64x128x256 -> 441) moves ~16 MB, ~5 us.
//
// Design (simple and correct first, not yet fast):
//  * one block = one output row segment of TW pixels for ONE displacement
//    row dy (grid.z = batch x displacement rows), one thread per pixel;
//  * channels are staged through shared memory in chunks of CC: the f1
//    segment and the f2 row segment haloed by md on each side. FlowNetC's
//    halo (2*md = 40 px) times 256 channels would not fit 227 KB, so the
//    chunking keeps shared memory at ~22 KB whatever C is;
//  * staging loads are 16 bytes per thread (8 bf16 / 4 f32 channels) when
//    C and the pointers allow it, one element otherwise;
//  * both tiles are stored channel-major ([c][x]) with odd plane strides,
//    so the transposed stores from coalesced NHWC loads and the per-pixel
//    reads of the compute loop are free of bank conflicts;
//  * each thread keeps the `steps` dx displacements of its pixel in f32
//    registers (MAXS is a compile-time bound, the loop is fully unrolled
//    and predicated so acc never spills to local memory);
//  * ragged edges: pixels past W are masked on store, f2 columns/rows
//    outside the map and channels past C are staged as zeros;
//  * 1/C is applied after the f32 sum, then the value is cast to the
//    output dtype; stores are scalar, so D^2 = 81 or 441 needs no tail.
// f1 is re-staged once per displacement row (from L2); a later PR can keep
// it resident and register-block the dx loop.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int TW = 64;  // output pixels per block, one thread each
constexpr int CC = 32;  // channels staged per pass

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// V consecutive channels from a 16-byte-aligned address, as floats
__device__ __forceinline__ void load_vec(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(h[j]);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// Stage pixels [x_first, x_first + ncol) of one image row (pixel index `row`
// of its x = 0) of an NHWC map, channels [c0, c0 + CC), into
// dst[c * stride + col]; zero outside the map or past C. V = channels per
// load: 1, or 16 bytes' worth when C and the pointers allow it.
template <typename T, int V>
__device__ __forceinline__ void stage(float* dst, int stride, const T* __restrict__ src,
                                      size_t row, bool row_ok, int x_first, int ncol,
                                      int W, int C, int c0, int tx) {
  constexpr int G = CC / V;  // loads per pixel
  for (int i = tx; i < ncol * G; i += TW) {
    const int c = (i % G) * V, col = i / G;
    const int gx = x_first + col, gc = c0 + c;
    float v[V];
    if (row_ok && gx >= 0 && gx < W && gc < C) {
      if constexpr (V == 1) {
        v[0] = to_f(src[(row + gx) * C + gc]);
      } else {
        load_vec(src + (row + gx) * C + gc, v);
      }
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) dst[(c + j) * stride + col] = v[j];
  }
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int MAXS, int V>
__global__ void __launch_bounds__(TW)
corr_fwd(const T* __restrict__ f1, const T* __restrict__ f2, T* __restrict__ out,
         int H, int W, int C, int md, int s2, int steps) {
  extern __shared__ float smem[];
  const int span = TW + 2 * md;  // f2 columns one row segment can touch
  const int f1_stride = TW + 1;  // odd plane strides: conflict-free stores
  const int f2_stride = span | 1;
  float* f1s = smem;                   // [CC][f1_stride]
  float* f2s = smem + CC * f1_stride;  // [CC][f2_stride]

  const int tx = threadIdx.x;
  const int x0 = blockIdx.x * TW;
  const int y = blockIdx.y;
  const int b = blockIdx.z / steps;
  const int iy = blockIdx.z % steps;
  const int yy = y - md + iy * s2;  // f2 row of this displacement row
  const bool row_ok = yy >= 0 && yy < H;

  const size_t row1 = ((size_t)b * H + y) * W;  // pixel index of (b, y, 0)
  const size_t row2 = ((size_t)b * H + (row_ok ? yy : 0)) * W;

  float acc[MAXS];
#pragma unroll
  for (int i = 0; i < MAXS; ++i) acc[i] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    stage<T, V>(f1s, f1_stride, f1, row1, true, x0, TW, W, C, c0, tx);
    stage<T, V>(f2s, f2_stride, f2, row2, row_ok, x0 - md, span, W, C, c0, tx);
    __syncthreads();
    const int cn = min(CC, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float a = f1s[c * f1_stride + tx];
      const float* r = f2s + c * f2_stride + tx;
#pragma unroll
      for (int ix = 0; ix < MAXS; ++ix)
        if (ix < steps) acc[ix] = fmaf(a, r[ix * s2], acc[ix]);
    }
    __syncthreads();
  }

  const int gx = x0 + tx;
  if (gx < W) {
    T* o = out + (row1 + gx) * (size_t)(steps * steps) + (size_t)iy * steps;
    const float fc = (float)C;
#pragma unroll
    for (int ix = 0; ix < MAXS; ++ix)
      if (ix < steps) o[ix] = from_f<T>(acc[ix] / fc);
  }
}

template <typename T, int MAXS, int V>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int H, int W,
                   int C, int md, int s2, int steps, cudaStream_t stream) {
  const dim3 grid((W + TW - 1) / TW, H, B * steps);
  const size_t smem = (size_t)CC * ((TW + 1) + ((TW + 2 * md) | 1)) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        corr_fwd<T, MAXS, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  corr_fwd<T, MAXS, V><<<grid, TW, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2), static_cast<T*>(out),
      H, W, C, md, s2, steps);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t dispatch_steps(const void* f1, const void* f2, void* out, int B, int H,
                           int W, int C, int md, int s2, cudaStream_t stream) {
  const int steps = 2 * (md / s2) + 1;
  if (steps <= 9) return launch<T, 9, V>(f1, f2, out, B, H, W, C, md, s2, steps, stream);
  if (steps <= 21) return launch<T, 21, V>(f1, f2, out, B, H, W, C, md, s2, steps, stream);
  if (steps <= 41) return launch<T, 41, V>(f1, f2, out, B, H, W, C, md, s2, steps, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch(const void* f1, const void* f2, void* out, int B, int H, int W,
                     int C, int md, int s2, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (C % V == 0) && reinterpret_cast<size_t>(f1) % 16 == 0 &&
                   reinterpret_cast<size_t>(f2) % 16 == 0;
  return vec ? dispatch_steps<T, V>(f1, f2, out, B, H, W, C, md, s2, stream)
             : dispatch_steps<T, 1>(f1, f2, out, B, H, W, C, md, s2, stream);
}

}  // namespace

// f1, f2: (B, H, W, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// out: (B, H, W, D^2) of the same dtype. Returns cudaGetLastError() of the
// launch (0 = success).
extern "C" int vps_correlation_forward(const void* f1, const void* f2, void* out,
                                       int B, int H, int W, int C, int md, int s2,
                                       int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || md < 0 || s2 <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(f1, f2, out, B, H, W, C, md, s2, st)
              : dispatch<float>(f1, f2, out, B, H, W, C, md, s2, st);
  return (int)e;
}

extern "C" const char* vps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
