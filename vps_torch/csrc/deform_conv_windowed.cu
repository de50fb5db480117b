// Windowed (offset-clamped) deformable convolution v1, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel vps_tpu/ops/deform_conv.py:_dcw_kernel
// (:447, launched by _deform_conv_windowed_pallas). The same function, given
// the per-tap products Y_k = X . W_k (B, H, W, K, Cout), which the caller
// computes with one matmul outside the kernel, as the JAX package does:
//
//   d_k(p)      = clamp(offset[b, y, x, 2k : 2k+2], -R, R)      (dy, dx), f32
//   out[b,y,x,c] = sum_k bilinear(Y_k[b, :, :, c],
//                                 (y + ky - pad + dy, x + kx - pad + dx))
//
// with Y_k reading zero outside the map, taps k = ky * kw + kx row-major,
// stride 1, no bias, no mask, f32 accumulation, f32 output.
//
// The TPU kernel sums over all (2R+2)^2 integer displacements with hat
// weights hat(dy - d) * hat(dx - e), because a TPU has no fast gather. Only
// the 4 floor/ceil corners of the clamped position have a nonzero hat
// weight, so on this card the same sum is a 4-corner bilinear read of Y_k:
// none of the TPU kernel's 100 passes per tap, activity intervals,
// pre-tiled overlapping column blocks or 128-channel blocks carry over, and
// B, H, W and Cout are free (Cout % 8 for bf16 / % 4 for f32 takes 16-byte
// loads, any other Cout a scalar path).
//
// What bounds it on an H100: bytes. Each launch reads Y once
// (K * HW * Cout elements), the offsets once (2K * HW f32) and writes the f32
// output once; the mixing is ~8 flops per corner and channel. At 1024x2048,
// the semantic head's 12 launches per frame move ~2.0 GB, ~0.6 ms at
// 3.35 TB/s.
//
// Design (simple and correct first, not yet fast):
//  * one thread = one pixel x V consecutive output channels (V = 8 bf16 /
//    4 f32: one 16-byte load per corner); the threads of one pixel are
//    neighbours, so each corner read is a coalesced row of Cout channels;
//  * each thread reads its pixel's 2K offsets (a broadcast within the warp),
//    clamps them, and per tap takes floor/weights in f32 (positions past 256
//    would quantise in bf16); a corner outside the map, or one whose weight
//    is exactly 0 (integer or +-R offsets put 0 on the ceil corner, which may
//    lie one pixel outside the map), is never read;
//  * corners of Y_k (in the compute dtype, as the TPU kernel keeps them) are
//    mixed into f32 registers and the f32 sum is written with 16-byte stores.
// Neighbouring pixels re-read overlapping Y windows through L1/L2. A faster
// version can stage the haloed Y_k window in shared memory (its size is
// bounded by R: the one place the window pays off on this card), or fuse the
// corner mix into the Y product on wgmma so Y never reaches device memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int THREADS = 256;

template <typename T, int V> struct Vec;

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <> struct Vec<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      v[2 * j] = f.x;
      v[2 * j + 1] = f.y;
    }
  }
};
template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float* v) { v[0] = __ldg(p); }
};
template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(p[0]);
  }
};

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
dcw_fwd(const T* __restrict__ y, const float* __restrict__ off, float* __restrict__ out,
        long long total, int groups, int H, int W, int C, int kh, int kw, int pad,
        float R) {
  const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (t >= total) return;
  const int g = (int)(t % groups);     // channel group: channels [g*V, g*V + V)
  const long long p = t / groups;      // pixel index ((b * H + y) * W + x)
  const int x = (int)(p % W);
  const int yr = (int)((p / W) % H);
  const long long img = p - ((long long)yr * W + x);  // pixel index of (b, 0, 0)
  const int K = kh * kw;
  const float* o = off + p * 2 * K;

  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;

  for (int k = 0; k < K; ++k) {
    const int ky = k / kw, kx = k - ky * kw;
    const float dy = fminf(fmaxf(__ldg(o + 2 * k), -R), R);
    const float dx = fminf(fmaxf(__ldg(o + 2 * k + 1), -R), R);
    const float ys = (float)(yr + ky - pad) + dy;
    const float xs = (float)(x + kx - pad) + dx;
    const float y0f = floorf(ys), x0f = floorf(xs);
    const float wy = ys - y0f, wx = xs - x0f;
    const int y0 = (int)y0f, x0 = (int)x0f;
    const float wgt[4] = {(1.f - wy) * (1.f - wx), (1.f - wy) * wx, wy * (1.f - wx), wy * wx};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int yy = y0 + (c >> 1), xx = x0 + (c & 1);
      if (wgt[c] == 0.f || yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
      const T* src = y + ((img + (long long)yy * W + xx) * K + k) * C + (long long)g * V;
      float v[V];
      Vec<T, V>::load(src, v);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wgt[c], v[j], acc[j]);
    }
  }

  float* dst = out + p * C + (long long)g * V;
  if constexpr (V == 1) {
    dst[0] = acc[0];
  } else {
#pragma unroll
    for (int j = 0; j < V; j += 4)
      *reinterpret_cast<float4*>(dst + j) = make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]);
  }
}

template <typename T, int V>
cudaError_t launch(const void* y, const void* off, void* out, int B, int H, int W, int C,
                   int kh, int kw, int pad, float R, cudaStream_t stream) {
  const int groups = C / V;
  const long long total = (long long)B * H * W * groups;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dcw_fwd<T, V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const float*>(off), static_cast<float*>(out),
      total, groups, H, W, C, kh, kw, pad, R);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y, const void* off, void* out, int B, int H, int W, int C,
                     int kh, int kw, int pad, float R, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const bool vec = (C % V == 0) && reinterpret_cast<size_t>(y) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  return vec ? launch<T, V>(y, off, out, B, H, W, C, kh, kw, pad, R, stream)
             : launch<T, 1>(y, off, out, B, H, W, C, kh, kw, pad, R, stream);
}

}  // namespace

// y: (B, H, W, kh*kw, C) contiguous, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1);
// off: (B, H, W, 2*kh*kw) f32 contiguous; out: (B, H, W, C) f32. Returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int vps_deform_conv_windowed_forward(const void* y, const void* off, void* out,
                                                int B, int H, int W, int C, int kh, int kw,
                                                int pad, int is_bf16, float window,
                                                void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || kh <= 0 || kw <= 0 || pad < 0 ||
      !(window >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? dispatch<__nv_bfloat16>(y, off, out, B, H, W, C, kh, kw, pad, window, st)
              : dispatch<float>(y, off, out, B, H, W, C, kh, kw, pad, window, st);
  return (int)e;
}

extern "C" const char* vps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
