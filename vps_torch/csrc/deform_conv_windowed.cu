// Windowed (offset-clamped) deformable convolution v1, forward, for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel vps_tpu/ops/deform_conv.py:_dcw_kernel
// (:447, launched by _deform_conv_windowed_pallas). The same function:
//
//   d_k(p)       = clamp(offset[b, y, x, 2k : 2k+2], -R, R)      (dy, dx), f32
//   S_k(p)       = bilinear(X[b], (y + ky - pad + dy, x + kx - pad + dx))
//   out[b,y,x,:] = sum_k S_k(p) . W_k
//
// with X reading zero outside the map, taps k = ky * kw + kx row-major,
// stride 1, no bias, no mask, f32 accumulation, f32 output. The TPU kernel
// sums over all (2R+2)^2 integer displacements with hat weights, because a
// TPU has no fast gather; only the 4 floor/ceil corners of the clamped
// position carry weight, so on this card each sample is a 4-corner read.
//
// What bounds it on an H100: operations, then bytes. The semantic head's 12
// launches a frame at 1024x2048 (3 convs x 4 levels, Cin 256/128) are
// ~359 GFLOP of bf16 products (~0.36 ms at 989 TF/s) while x, the offsets,
// the weights and the f32 output are ~0.26 GB (~0.08 ms at 3.35 TB/s). The
// earlier route materialised the tap products Y_k = X . W_k (Cout values per
// pixel and tap, ~1.6 GB a frame written and read back) and mixed them in a
// second kernel.
//
// Two routes, chosen by dtype:
//
// bf16 (every input a preset gives it): dcw_fused, one implicit-GEMM kernel
// that never forms Y.
//  * A block owns 128 output pixels (an 8 x 16 tile of one image, so corner
//    reads of neighbouring pixels stay in L1) x BN output channels: BN = 256
//    where Cout > 128, so each sample is gathered once, else 128. 4
//    warpgroups (2 along the pixels x 2 along the channels) each hold a
//    64 x BN/2 f32 accumulator of wgmma (m64nBN/2k16, bf16 in) in registers
//    across every tap and input channel.
//  * At the start the block turns its pixels' 2K offsets into a table: per
//    pixel and tap, the pixel index of the floor corner and the 4 bilinear
//    weights, each set to 0 where its corner lies outside the map.
//  * The reduction runs over units (64 input channels, tap), taps inner so
//    the taps of one channel chunk reuse the same window through L1. Per
//    unit, every warpgroup issues its wgmma on the unit's tiles and, while
//    the tensor cores run, the threads build the next unit's A tile and
//    issue the loads of the one after: 16-byte reads of the corners with
//    nonzero weight (one unit ahead of their use), mixed in f32 in the plain
//    version's order ((y0,x0), (y0,x0+1), (y0+1,x0), (y0+1,x0+1)) with
//    separate multiplies and adds, rounded to bf16 and stored to shared
//    memory. The A tile therefore holds exactly the plain version's rounded
//    samples, and the result differs from it only in the order of the f32
//    sum.
//  * B: the wrapper lays the weight out once as (K, Cin / 64, Cout padded to
//    BN, 64) bf16, zero-padded and pre-swizzled, so each unit's B tile is one
//    contiguous slab that a single bulk async copy brings in, 3 units ahead,
//    completing on an mbarrier.
//  * Both tiles are K-major 128-byte rows with the 128-byte swizzle that the
//    wgmma descriptors name (16-byte chunk c of row r at c ^ (r % 8)).
//  * A grid too small to fill the card (the coarse levels) splits the units
//    over blocks; each writes a partial sum and sum_parts adds them in a
//    fixed order, so the result is deterministic.
//  * Epilogue: the accumulators go through shared memory and each pixel's
//    output channels are written with 16-byte stores (Cout % 4 == 0; any
//    other Cout element-wise).
//  * Edges: pixels outside the map give all-zero weights and are not stored;
//    output channels past Cout and input channels past Cin are zero in B and
//    A. Cin % 8 == 0 takes 16-byte corner reads; any other Cin reads
//    element by element.
//  What bounds it, measured on the card: the gathers and the f32 mix (about
//  130 instructions per 8 channels, tap and pixel) and the L2 traffic of
//  the weight slabs (the whole weight for every 128 pixels), not the tensor
//  cores.
//
// f32 (no preset gives it): dcw_mix, the first port's kernel, on tap
// products Y_k that the caller forms with one matmul: one thread per pixel
// and 4 output channels mixes the 4 corners of Y_k per tap into f32
// registers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ f32 mix route

namespace mix {

constexpr int THREADS = 256;

template <int V>
__global__ void __launch_bounds__(THREADS)
dcw_mix(const float* __restrict__ y, const float* __restrict__ off, float* __restrict__ out,
        long long total, int groups, int H, int W, int C, int kh, int kw, int pad, float R) {
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
      const float* src = y + ((img + (long long)yy * W + xx) * K + k) * C + (long long)g * V;
      float v[V];
      if constexpr (V == 4) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(src));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        v[0] = __ldg(src);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = fmaf(wgt[c], v[j], acc[j]);
    }
  }

  float* dst = out + p * C + (long long)g * V;
  if constexpr (V == 1) {
    dst[0] = acc[0];
  } else {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

template <int V>
cudaError_t launch(const void* y, const void* off, void* out, int B, int H, int W, int C,
                   int kh, int kw, int pad, float R, cudaStream_t stream) {
  const int groups = C / V;
  const long long total = (long long)B * H * W * groups;
  const long long blocks = (total + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  dcw_mix<V><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const float*>(y), static_cast<const float*>(off), static_cast<float*>(out),
      total, groups, H, W, C, kh, kw, pad, R);
  return cudaGetLastError();
}

}  // namespace mix

// ------------------------------------------------- bf16 fused tensor cores

namespace fused {

constexpr int TH = 8, TWX = 16;       // pixel tile: 8 rows x 16 columns
constexpr int BM = TH * TWX;          // 128 pixels
constexpr int KC = 64;                // input channels per unit
constexpr int ROWB = KC * 2;          // 128-byte rows
constexpr int A_TILE = BM * ROWB;     // 16 KB


// 4 warpgroups: 2 along the pixels x 2 along the channels, each 64 pixels x
// BN / 2 channels
template <int BN>
struct Cfg {
  static constexpr int THREADS = 512;
  static constexpr int WN = BN / 2;                 // channels a warpgroup
  static constexpr int ITEMS = BM * 8 / THREADS;    // gather items a thread, a unit
  static constexpr int B_TILE = BN * ROWB;          // a multiple of 1024 bytes
  static constexpr int OUT_PITCH = BN + 4;          // floats per staged output row
  // B ring stages: the weight slabs' copies run NSB - 1 units ahead, as
  // deep as shared memory allows (their latency, not L2's bandwidth, bounds
  // them)
  static constexpr int NSB = BN == 256 ? 5 : 8;
};

// 2 A stages, C::NSB B stages, the corner table, the B barriers, and 1 KB to
// align the stages to 1024 bytes (the swizzle works on absolute address
// bits); the staged output reuses the stages
template <int BN>
size_t smem_bytes(int K) {
  using C = Cfg<BN>;
  const size_t stages = 2 * (size_t)A_TILE + (size_t)C::NSB * C::B_TILE;
  const size_t loop = stages + (size_t)K * BM * (sizeof(float4) + sizeof(int)) +
                      C::NSB * sizeof(uint64_t);
  const size_t epi = (size_t)BM * C::OUT_PITCH * sizeof(float);
  return 1024 + (loop > epi ? loop : epi);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// one bulk copy of `bytes` contiguous bytes into shared memory; `bar`'s
// current phase completes when they have landed
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%2], %3;\n"
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %3, [%2];\n"
      "}\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(smem_u32(bar)), "r"(bytes)
      : "memory");
}
// wait for the completion of the barrier's phase of this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// make this thread's shared-memory writes visible to the tensor cores' reads
__device__ __forceinline__ void fence_async_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// descriptor of a K-major tile of 128-byte rows with the 128-byte swizzle:
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}
// d (64 x 128 f32 over the warpgroup) += A (64 x 16 bf16) . B^T (128 x 16
// bf16), both K-major in shared memory with the 128-byte swizzle
__device__ __forceinline__ void wgmma_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
// d (64 x 64 f32 over the warpgroup) += A (64 x 16 bf16) . B^T (64 x 16
// bf16), both K-major in shared memory with the 128-byte swizzle
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}
// chunk ch (16 bytes) of 128-byte row r, XOR-swizzled by r & 7
__device__ __forceinline__ int swz(int r, int ch) { return r * ROWB + ((ch ^ (r & 7)) << 4); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&h);
}

// One gather item: pixel r of the tile, channels gc .. gc + 7, one tap.
// load() issues the reads of the corners with nonzero weight (VEC: one
// 16-byte read each, Cin % 8 == 0; else element by element, zeros past
// Cin); store() mixes them in f32 in the plain version's corner order, with
// separate multiplies and adds, rounds to bf16 and writes the A tile's chunk.
struct Gather {
  uint4 q[4];
  float4 w;
  template <bool VEC>
  __device__ __forceinline__ void load(const uint16_t* __restrict__ ximg,
                                       const int* __restrict__ tab_p,
                                       const float4* __restrict__ tab_w, int e, int W,
                                       int Cin, int gc) {
    w = gc < Cin ? tab_w[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    const int p00 = tab_p[e];
    const float wc[4] = {w.x, w.y, w.z, w.w};
    const int pc[4] = {p00, p00 + 1, p00 + W, p00 + W + 1};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const uint16_t* src = ximg + (ptrdiff_t)pc[c] * Cin + gc;
      if constexpr (VEC) {
        q[c] = wc[c] != 0.f ? __ldg(reinterpret_cast<const uint4*>(src)) : make_uint4(0, 0, 0, 0);
      } else {
        uint32_t h[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int ci = gc + 2 * j;
          const uint32_t lo = wc[c] != 0.f && ci < Cin ? __ldg(src + 2 * j) : 0u;
          const uint32_t hi = wc[c] != 0.f && ci + 1 < Cin ? __ldg(src + 2 * j + 1) : 0u;
          h[j] = lo | (hi << 16);
        }
        q[c] = make_uint4(h[0], h[1], h[2], h[3]);
      }
    }
  }
  __device__ __forceinline__ void store(char* dst) const {
    const float wc[4] = {w.x, w.y, w.z, w.w};
    // the first corner's product is taken as is: 0 + p differs from p only
    // in the sign of a zero, which no later sum can see
    float m[8];
    {
      const uint32_t h[4] = {q[0].x, q[0].y, q[0].z, q[0].w};  // zeros if weight 0
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[2 * j] = __fmul_rn(__uint_as_float(h[j] << 16), wc[0]);
        m[2 * j + 1] = __fmul_rn(__uint_as_float(h[j] & 0xffff0000u), wc[0]);
      }
    }
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      if (wc[c] == 0.f) continue;
      const uint32_t h[4] = {q[c].x, q[c].y, q[c].z, q[c].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        m[2 * j] = __fadd_rn(m[2 * j], __fmul_rn(__uint_as_float(h[j] << 16), wc[c]));
        m[2 * j + 1] =
            __fadd_rn(m[2 * j + 1], __fmul_rn(__uint_as_float(h[j] & 0xffff0000u), wc[c]));
      }
    }
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack_bf16(m[0], m[1]), pack_bf16(m[2], m[3]), pack_bf16(m[4], m[5]),
                   pack_bf16(m[6], m[7]));
  }
};

template <int BN, bool VEC>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, 1)
dcw_fused(const uint16_t* __restrict__ x, const float* __restrict__ off,
          const uint16_t* __restrict__ wt, float* __restrict__ out, int H, int W, int Cin,
          int Cout, int kh, int kw, int pad, float R, int co_tiles, int splits,
          int units_per_split, size_t part_stride) {
  using C = Cfg<BN>;
  constexpr int THREADS = C::THREADS, ITEMS = C::ITEMS, NSB = C::NSB;
  extern __shared__ __align__(1024) char smem_raw[];
  char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  char* a_st = smem;                   // 2 A tiles
  char* b_st = smem + 2 * A_TILE;      // NSB B tiles
  const int K = kh * kw;
  float4* tab_w = reinterpret_cast<float4*>(b_st + NSB * C::B_TILE);  // [K][BM]
  int* tab_p = reinterpret_cast<int*>(tab_w + K * BM);                // [K][BM]
  uint64_t* b_bar = reinterpret_cast<uint64_t*>(tab_p + K * BM);      // [NSB]
  float* out_s = reinterpret_cast<float*>(smem);  // after the loop: [BM][OUT_PITCH]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, mi = wg & 1, ni = wg >> 1;  // warpgroup: 64 pixels x WN channels
  constexpr int RSTEP = THREADS / 8;                    // gather rows a pass
  const int tx0 = blockIdx.x * TWX, ty0 = blockIdx.y * TH;
  const int split = blockIdx.z % splits, bz = blockIdx.z / splits;
  const int b = bz / co_tiles, co0 = (bz % co_tiles) * BN;
  out += split * part_stride;  // splits > 1: this block's partial sum
  const uint16_t* ximg = x + (size_t)b * H * W * Cin;
  const int nck = (Cin + KC - 1) / KC;
  if (tid == 0)
    for (int s = 0; s < NSB; ++s) mbar_init(&b_bar[s], 1);

  // offsets -> corner table: floor-corner pixel index and 4 weights per
  // (tap, pixel), a weight 0 where its corner is outside the map
  for (int i = tid; i < K * BM; i += THREADS) {
    const int k = i / BM, r = i - k * BM;
    const int py = ty0 + r / TWX, px = tx0 + r % TWX;
    int p00 = 0;
    float4 w4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (py < H && px < W) {
      const float* o = off + (((size_t)b * H + py) * W + px) * 2 * K + 2 * k;
      const float dy = fminf(fmaxf(o[0], -R), R);
      const float dx = fminf(fmaxf(o[1], -R), R);
      const float ys = (float)(py + k / kw - pad) + dy;
      const float xs = (float)(px + k % kw - pad) + dx;
      const float y0f = floorf(ys), x0f = floorf(xs);
      const float wy = ys - y0f, wx = xs - x0f;
      const int y0 = (int)y0f, x0 = (int)x0f;
      const bool y0_in = y0 >= 0 && y0 < H, y1_in = y0 + 1 >= 0 && y0 + 1 < H;
      const bool x0_in = x0 >= 0 && x0 < W, x1_in = x0 + 1 >= 0 && x0 + 1 < W;
      const float uy = 1.f - wy, ux = 1.f - wx;
      w4.x = (y0_in && x0_in) ? __fmul_rn(uy, ux) : 0.f;
      w4.y = (y0_in && x1_in) ? __fmul_rn(uy, wx) : 0.f;
      w4.z = (y1_in && x0_in) ? __fmul_rn(wy, ux) : 0.f;
      w4.w = (y1_in && x1_in) ? __fmul_rn(wy, wx) : 0.f;
      p00 = y0 * W + x0;
    }
    tab_w[i] = w4;
    tab_p[i] = p00;
  }

  // B tile of unit u: one contiguous, pre-swizzled slab of the prepared
  // weight (K, nck, Cout padded to BN tiles, 64), copied by one thread
  const int cout_pad = co_tiles * BN;
  auto copy_b = [&](int u, int slot) {
    const int ck = u / K, k = u - ck * K;
    bulk_copy(b_st + slot * C::B_TILE,
              wt + (((size_t)k * nck + ck) * cout_pad + co0) * KC, C::B_TILE, &b_bar[slot]);
  };
  // gather items of this thread: pixels (tid >> 3) + RSTEP j at chunk tid & 7.
  // The corner loads of a unit are issued one unit before their mix.
  const int ch = tid & 7, r0 = tid >> 3;
  Gather gi[ITEMS];
  auto load_a = [&](int u) {
    const int ck = u / K, k = u - ck * K, gc = ck * KC + ch * 8;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      gi[j].template load<VEC>(ximg, tab_p, tab_w, k * BM + r0 + RSTEP * j, W, Cin, gc);
  };
  auto store_a = [&](char* st) {
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) gi[j].store(st + swz(r0 + RSTEP * j, ch));
  };

  float acc[C::WN / 2];
#pragma unroll
  for (int i = 0; i < C::WN / 2; ++i) acc[i] = 0.f;

  // units (channel chunk, tap), taps inner; this block takes [u0, u1)
  const int u0 = split * units_per_split, u1 = min(nck * K, u0 + units_per_split);
  __syncthreads();  // the table and the barriers
  if (tid == 0)
    for (int p = 0; p < NSB - 1 && u0 + p < u1; ++p) copy_b(u0 + p, p);
  load_a(u0);
  store_a(a_st);
  if (u0 + 1 < u1) load_a(u0 + 1);
  for (int u = u0; u < u1; ++u) {
    const int i = u - u0, cur = i & 1, slot = i % NSB;
    fence_async_proxy();
    __syncthreads();  // A of unit u complete; every warpgroup done with unit u - 1
    if (tid == 0 && u + NSB - 1 < u1) copy_b(u + NSB - 1, (i + NSB - 1) % NSB);
    mbar_wait(&b_bar[slot], (i / NSB) & 1);  // B of unit u has landed
    // this warpgroup's product of unit u, in flight while the next unit's A
    // tile is mixed and the one after is loaded
    const int ck = u / K;
    const uint32_t a0 = smem_u32(a_st + cur * A_TILE) + mi * 64 * ROWB;
    const uint32_t b0 = smem_u32(b_st + slot * C::B_TILE) + ni * C::WN * ROWB;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      if (ck * KC + kk * 16 >= Cin) break;  // only zero channels left
      if constexpr (C::WN == 128)
        wgmma_n128(acc, wgmma_desc(a0 + 32 * kk), wgmma_desc(b0 + 32 * kk));
      else
        wgmma_n64(acc, wgmma_desc(a0 + 32 * kk), wgmma_desc(b0 + 32 * kk));
    }
    wgmma_commit();
    if (u + 1 < u1) store_a(a_st + (cur ^ 1) * A_TILE);
    if (u + 2 < u1) load_a(u + 2);
    wgmma_wait_all();
  }

  // epilogue: accumulators -> shared [pixel][channel] -> 16-byte stores.
  // Accumulator 4j + 2h + e of a thread: pixel 16 (warp & 3) + lane / 4 + 8h,
  // channel 8j + 2 (lane & 3) + e of its warpgroup's tile.
  __syncthreads();  // every warpgroup is done with the stages
  {
    const int g = lane >> 2, q = 2 * (lane & 3);
    const int row = mi * 64 + (warp & 3) * 16 + g;
#pragma unroll
    for (int j = 0; j < C::WN / 8; ++j) {
      float* o = out_s + row * C::OUT_PITCH + ni * C::WN + 8 * j + q;
      *reinterpret_cast<float2*>(o) = make_float2(acc[4 * j], acc[4 * j + 1]);
      *reinterpret_cast<float2*>(o + 8 * C::OUT_PITCH) =
          make_float2(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
  __syncthreads();
  const int ncol = min(BN, Cout - co0);
  const bool vec = (Cout & 3) == 0;
  const int per_px = vec ? BN / 4 : BN;  // items per pixel row
  for (int i = tid; i < BM * per_px; i += THREADS) {
    const int r = i / per_px, c = (i - r * per_px) * (vec ? 4 : 1);
    const int py = ty0 + r / TWX, px = tx0 + r % TWX;
    if (py >= H || px >= W || c >= ncol) continue;
    float* dst = out + (((size_t)b * H + py) * W + px) * Cout + co0 + c;
    const float* src = out_s + r * C::OUT_PITCH + c;
    if (vec)
      *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
    else
      *dst = *src;
  }
}

// out[i] = sum over s, in order, of part[s][i]
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ part, float* __restrict__ out, size_t n, int splits) {
  const size_t n4 = n % 4 == 0 ? n / 4 : 0;  // every part 16-byte aligned
  for (size_t i = (size_t)blockIdx.x * 256 + threadIdx.x; i < n4; i += (size_t)gridDim.x * 256) {
    float4 a = reinterpret_cast<const float4*>(part)[i];
    for (int s = 1; s < splits; ++s) {
      const float4 v = reinterpret_cast<const float4*>(part + s * n)[i];
      a.x += v.x; a.y += v.y; a.z += v.z; a.w += v.w;
    }
    reinterpret_cast<float4*>(out)[i] = a;
  }
  for (size_t i = n4 * 4 + (size_t)blockIdx.x * 256 + threadIdx.x; i < n;
       i += (size_t)gridDim.x * 256) {
    float a = part[i];
    for (int s = 1; s < splits; ++s) a += part[s * n + i];
    out[i] = a;
  }
}

struct Plan {
  int bn, co_tiles, splits, units_per_split;
};

// Tile width and the split of the reduction over blocks: a grid that would
// leave SMs idle splits its (channel chunk, tap) units into up to that many
// parts, each a block writing a partial sum.
Plan plan(int B, int H, int W, int Cin, int Cout, int K) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  Plan p;
  p.bn = Cout > 128 ? 256 : 128;  // a 256-channel tile gathers each sample once
  p.co_tiles = (Cout + p.bn - 1) / p.bn;
  const long long blocks = (long long)B * p.co_tiles * ((H + TH - 1) / TH) * ((W + TWX - 1) / TWX);
  const long long slots = sms;  // one resident block an SM
  const int units = (Cin + KC - 1) / KC * K;
  int splits = blocks >= slots ? 1 : (int)((slots + blocks - 1) / blocks);
  splits = splits < units ? splits : units;
  p.units_per_split = (units + splits - 1) / splits;
  p.splits = (units + p.units_per_split - 1) / p.units_per_split;
  return p;
}

template <int BN, bool VEC>
cudaError_t launch(const void* x, const void* off, const void* wt, void* out, void* part,
                   int B, int H, int W, int Cin, int Cout, int kh, int kw, int pad,
                   float window, const Plan& p, cudaStream_t stream) {
  const long long gz = (long long)B * p.co_tiles * p.splits;
  if (gz > 65535 || (H + TH - 1) / TH > 65535) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<BN>(kh * kw);
  static size_t smem_set = 0;  // the attribute only ever grows
  if (smem > smem_set) {
    cudaError_t e = cudaFuncSetAttribute(
        dcw_fused<BN, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_set = smem;
  }
  const size_t n = (size_t)B * H * W * Cout;
  const dim3 grid((W + TWX - 1) / TWX, (H + TH - 1) / TH, (unsigned)gz);
  dcw_fused<BN, VEC><<<grid, Cfg<BN>::THREADS, smem, stream>>>(
      static_cast<const uint16_t*>(x), static_cast<const float*>(off),
      static_cast<const uint16_t*>(wt), static_cast<float*>(p.splits > 1 ? part : out), H, W,
      Cin, Cout, kh, kw, pad, window, p.co_tiles, p.splits, p.units_per_split, n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || p.splits == 1) return e;
  const size_t blocks = (n / 4 + 255) / 256;
  sum_parts<<<(unsigned)(blocks < 1024 ? (blocks > 0 ? blocks : 1) : 1024), 256, 0, stream>>>(
      static_cast<const float*>(part), static_cast<float*>(out), n, p.splits);
  return cudaGetLastError();
}

}  // namespace fused


bool takes(int B, int H, int W, int Cin, int Cout, int kh, int kw, int pad, float window) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cout <= 0 || kh <= 0 || kw <= 0 || pad < 0 ||
      !(window >= 0.f) ||
      (size_t)H * W * (Cin > Cout ? Cin : Cout) >= (1ull << 31))
    return false;
  // the corner table grows with the taps: 3 x 3 fits either tile width
  const size_t smem = Cout > 128 ? fused::smem_bytes<256>(kh * kw)
                                 : fused::smem_bytes<128>(kh * kw);
  return smem <= 227 * 1024;
}

}  // namespace

// bf16 route: the output-channel tile `bn` (the prepared weight pads Cout
// to a multiple of it) and how many partial sums (B, H, W, Cout) f32 the
// launch needs in its scratch `part` (1: none, part may be null). Returns 0
// if the kernel does not take the input, else 1.
extern "C" int vps_deform_conv_windowed_plan(int B, int H, int W, int Cin, int Cout, int kh,
                                             int kw, int pad, float window, int* bn,
                                             int* splits) {
  if (!takes(B, H, W, Cin, Cout, kh, kw, pad, window)) return 0;
  const fused::Plan p = fused::plan(B, H, W, Cin, Cout, kh * kw);
  *bn = p.bn;
  *splits = p.splits;
  return 1;
}

// bf16 route. x: (B, H, W, Cin) bf16; off: (B, H, W, 2*kh*kw)
// f32; wt: the prepared weight (kh*kw, ceil(Cin / 64), Cout padded to bn,
// 64) bf16, zero-padded, each row's 16-byte chunk c stored at c ^ (row % 8);
// out: (B, H, W, Cout) f32; part: splits x (B, H, W, Cout) f32 scratch (see
// vps_deform_conv_windowed_plan); all contiguous and 16-byte aligned.
// Returns cudaGetLastError() of the launches (0 = success), or
// cudaErrorInvalidValue for input the kernel does not take.
extern "C" int vps_deform_conv_windowed_fused(const void* x, const void* off, const void* wt,
                                              void* out, void* part, int B, int H, int W,
                                              int Cin, int Cout, int kh, int kw, int pad,
                                              float window, void* stream) {
  using namespace fused;
  if (!takes(B, H, W, Cin, Cout, kh, kw, pad, window)) return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<size_t>(x) | reinterpret_cast<size_t>(off) |
       reinterpret_cast<size_t>(wt) | reinterpret_cast<size_t>(out) |
       reinterpret_cast<size_t>(part)) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Plan p = plan(B, H, W, Cin, Cout, kh * kw);
  if (p.splits > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto run = [&](auto kernel_launch) {
    return (int)kernel_launch(x, off, wt, out, part, B, H, W, Cin, Cout, kh, kw, pad, window, p,
                              st);
  };
  if (Cin % 8 == 0)  // 16-byte corner reads
    return p.bn == 256 ? run(launch<256, true>) : run(launch<128, true>);
  return p.bn == 256 ? run(launch<256, false>) : run(launch<128, false>);
}

// f32 route, on precomputed tap products. y: (B, H, W, kh*kw, C) f32; off:
// (B, H, W, 2*kh*kw) f32; out: (B, H, W, C) f32; contiguous. Returns
// cudaGetLastError() of the launch (0 = success).
extern "C" int vps_deform_conv_windowed_mix(const void* y, const void* off, void* out, int B,
                                            int H, int W, int C, int kh, int kw, int pad,
                                            float window, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || kh <= 0 || kw <= 0 || pad < 0 ||
      !(window >= 0.f))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(y) % 16 == 0 &&
                   reinterpret_cast<size_t>(out) % 16 == 0;
  const cudaError_t e =
      vec ? mix::launch<4>(y, off, out, B, H, W, C, kh, kw, pad, window, st)
          : mix::launch<1>(y, off, out, B, H, W, C, kh, kw, pad, window, st);
  return (int)e;
}

extern "C" const char* vps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
