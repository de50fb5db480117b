// Correlation cost volume, forward and backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel vps_tpu/ops/correlation.py:_corr_kernel
// (launched by _correlation_pallas_2d). The same function:
//
//   out[b, y, x, k] = (1/C) * sum_c f1[b, y, x, c] * f2[b, y+dy, x+dx, c]
//
// for the k-th displacement (dy, dx) in {-md .. md step s2}^2, row-major with
// dy outer; f2 reads zero outside the map; accumulation in f32; the output is
// channel-last (B, H, W, D^2) in the input dtype (FlowNetC: md 20, s2 2, 441
// channels; LiteFlowNetCorr: md 4, s2 1, 81 channels).
//
// What bounds it on an H100: bytes. Counting each input byte read once and
// each output byte written once, LiteFlowNetCorr at 1024x2048 (256x512x256
// bf16 maps -> 81 channels) moves ~155 MB, ~46 us at 3.35 TB/s, while its
// 5.4 GFLOP take ~5.5 us at the 989 TF/s bf16 peak; FlowNetC at half-flow
// (64x128x256 -> 441) moves ~16 MB, ~5 us. What bounds a kernel in practice
// is the re-reading: each f2 row serves D output rows, and each output row
// needs D f2 rows, so the f2 traffic from L2 is ~D times the map.
//
// Two routes, chosen by dtype:
//
// bf16 (every preset that runs correlation in bf16): corr_bf16_tc, a band
// product on the tensor cores.
//  * A block owns S = 64 output pixels of one row (48 at s2 = 3) and walks
//    every displacement row itself, so its output is one contiguous span of
//    S * D^2 values per row. 8 warps: 4 m-tiles of 16 pixels x 2 groups.
//  * Each m-tile holds pixels of one residue class mod s2 (x = x_t + s2 i).
//    The f2 columns they need are then one dense band of the same residue
//    (x_t - md + s2 n, n < 15 + D), and P = F1_tile . F2_band^T runs as NT =
//    ceil((15 + D) / 8) n-tiles of mma.sync m16n8k16 (bf16 in, f32
//    accumulators). LiteFlowNetCorr: 3 n-tiles; FlowNetC: 5 (36 of 40
//    columns used).
//  * The f1 segment is staged once and kept in registers as A fragments
//    (C <= 256: 64 registers), so shared memory holds only the f2 ring. For
//    C > 256 each pipeline unit stages its 64-channel f1 chunk beside its f2
//    rows instead, and the fragments are read from there.
//  * For s2 > 4 a block takes 4 of the s2 residue classes of a 16 s2-pixel
//    segment and stages only their pixels, interleaved as at s2 = 4, so the
//    band product is the same; its output is stored straight out.
//  * f2 row segments (S + 2 md columns, haloed by md) are staged in bf16 by
//    cp.async, 64 channels a unit, in a ring of up to 8 stages, so the copies
//    of later units run while one is multiplied. The 2 warp groups take
//    alternate displacement rows of the same output row or, where the grid
//    stays large (LiteFlowNetCorr), output rows y and y + s2, which share
//    every staged f2 row: D + 1 staged rows serve 2 output rows.
//  * Operands reach the tensor cores through ldmatrix from 128-byte rows
//    whose 16-byte chunks are XOR-swizzled by (row / e) & 7, e = min(s2, 4):
//    the 8 rows an ldmatrix phase reads are e apart and land in 8 distinct
//    bank groups.
//  * Epilogue: each accumulator P[i][n] is out[x_i, dy, n - i] when
//    0 <= n - i < D; it is scaled by 1/C in f32, rounded to bf16 and put
//    straight into the block's output tile in shared memory, written out
//    with 16-byte stores at the end (where the tile would not fit, D^2 >
//    ~1000 at s2 >= 2, straight to device memory).
//  * Products of bf16 values are exact in f32, so the result differs from
//    the plain version only in the order of the f32 sum.
//  * Edges: pixels past W, f2 columns outside the map and channels past C
//    are staged as zeros; displacement rows outside the map skip the product
//    and give zeros. Any B, W, C and s2; D <= 41. C % 8 == 0 with 16-byte
//    aligned maps takes cp.async; any other C is staged element by element.
//
// f32 (the exact preset and every train step; tensor cores would change the
// answer through TF32): corr_f32, a register-tiled band product on the CUDA
// cores, f32 products and f32 sums. What bounds it on an H100: at
// LiteFlowNetCorr's training shape (1, 200, 400, 256) md 4, bytes (190 MB,
// 0.057 ms) and FMAs (1.66 G, 0.050 ms at 67 TF/s) nearly equally; FlowNetC
// (1, 56, 104, 256) md 20 s2 2 is FMA-bound (0.020 ms). On the CUDA cores
// the shared-memory pipe (one warp-wide 16-byte load per 4 clocks, against 4
// warp-wide FMAs a clock) is the first wall, so the design counts FMAs per
// shared load; the second is the re-reading of f2 from L2, so it counts
// staged rows per output row:
//  * A block owns S pixels (32 at s2 = 1; residue classes of s2, as the bf16
//    route, else) of R output rows y + r s2 and walks every displacement
//    row: D + R - 1 staged f2 rows serve all R. R = 4 where the grid stays
//    large (LiteFlowNetCorr: 3 staged rows an output row), else 2 (FlowNetC
//    at the training shape, whose grid would not fill the card). The
//    block's output spans are written once, coalesced, from a tile in shared
//    memory (where D^2 is too large, straight out).
//  * A thread owns one row pair, one staged f2 row, P = 4 pixels of one
//    residue class, a group of G dx (all 9 for LiteFlowNetCorr; 3 groups of
//    7 for FlowNetC's 21) and a slice of every 32-channel chunk (4 slices
//    with 2 rows, 2 with 4): 2 x P x G f32 sums; per 4 channels 2 P + P +
//    G - 1 16-byte shared loads for 8 P G FMAs (20 loads for 288 FMAs at
//    LiteFlowNetCorr). The slices are summed by shuffles once a pass. The
//    16-byte quads of a staged column are XOR-swizzled by its tile, so the
//    loads are free of bank conflicts.
//  * f1 chunks of the R rows and f2 row chunks (S + 2 md columns) are staged
//    by cp.async into a ring of 2-4 stages: the copies of the next unit run
//    while one is multiplied. Where the threads or the ring cannot hold all
//    staged rows (FlowNetC: 3 passes of 8), the rows go in passes.
//  * What holds it above its bound (timing ablations, PERF.md): two floors
//    of about the same size, the staging alone (L2 to shared memory) and
//    the product alone (latency-bound: one block of 10 warps an SM, held
//    there by the ring's shared memory and 168 registers a thread).
//  * Edges: pixels past W, f2 columns outside the map and channels past C
//    are staged as zeros; displacement rows outside the map are not staged
//    and give zeros. Any B, H, W, C and s2; D <= 41. C % 4 == 0 with 16-byte
//    aligned maps takes cp.async; any other C is staged element by element.
//  * The result differs from the plain version only in the order of the f32
//    sum.
//
// Backward (corr_backward; replaces the VJP of _correlation_xla that
// vps_tpu/ops/correlation.py:_correlation_bwd takes, the backward half of
// _corr_kernel's custom_vjp), for f32 and bf16 with f32 sums:
//
//   grad_f1[b,y,x,c] = (1/C) sum_k g[b,y,x,k] f2[b,y+dy,x+dx,c]
//   grad_f2[b,y,x,c] = (1/C) sum_k g[b,y-dy,x-dx,k] f1[b,y-dy,x-dx,c]
//
// What bounds it on an H100: at LiteFlowNetCorr's training shape
// (1, 200, 400, 256) f32, md 4, reading f1, f2 and g once and writing both
// gradients moves 354 MB (0.106 ms at 3.35 TB/s) and the 6.6 GFLOP take
// 0.099 ms at the 67 TF/s f32 peak: both, nearly equally. One launch, both
// gradients, in one form: grad_f2 is grad_f1's with g read through the
// mirrored index (feature row and column y - md + e + jy s2, x - md + e +
// jx s2, weight g at that pixel, displacement D^2 - 1 - jy D - jx; e = 2 (md
// mod s2)), so one band product serves both (the kernel's head comment).
// Every output element is written by one thread: no atomics, deterministic.
// A register-tiled band product on the CUDA cores, f32 products and sums
// (the f32 policy forbids TF32; the bf16 instance stages bf16 and widens at
// the shared load). What its design counts:
//  * Shared loads per FMA: a warp-wide shared load costs about the same
//    whether it is a 4-byte broadcast or 512 contiguous bytes (measured on
//    an H100), so the design counts loads, not bytes. A warp owns 2 output
//    rows x 4 pixels of one residue class mod s2, a lane 8 channels (2
//    quads, lane and lane + 32: a warp reads 512 contiguous bytes of a
//    staged column, no bank conflict and no swizzle): 64 f32 sums. A band
//    column costs 2 feature and 2 weight loads (16-byte) for up to 64 FMAs;
//    the weights of column n sit diagonally (wd[n][row][p] = w[row][p][n -
//    p]), staged by the warp itself, so each is one broadcast load of 4.
//  * Staged rows per output row: a block owns R = 4 rows (s2 apart) of 16
//    pixels and 256 channels (128 where C <= 128, or where a ring for two
//    blocks an SM does not fit 256: FlowNetC's geometry), so D + 3 staged
//    feature rows serve 4 output rows; the band's ramps (the first and last
//    P - 1 columns) issue only their products.
//  * Overlap: feature rows are staged by cp.async (16 bytes, zeros outside
//    the map) and the weights by 4-byte cp.async (plain loads for bf16)
//    into a ring of up to 4 stages; outputs leave by streaming 16-byte
//    stores (they would evict the staged rows from L2). 8 warps a block
//    and 110 KB of shared memory, so two blocks share an SM and one's
//    barriers, ramps and stores overlap the other's work.
//  * What holds it above its bound (timing ablations, PERF.md): the
//    product alone and the staging with the stores alone, of similar size.
//  * Edges: any B, H, W, C and s2; D <= 41. Pixels past W, feature columns
//    outside the map and channels past C stage zeros; rows outside the map
//    are not staged. C % 4 (f32) or 8 (bf16) == 0 with 16-byte aligned maps
//    takes cp.async; any other C is staged element by element.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

// ---------------------------------------------------- cp.async (both routes)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool ok) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
// wait until at most n groups are pending (n is an immediate in PTX)
__device__ __forceinline__ void cp_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::); break;
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// ---------------------------------------------------------------- f32 SIMT

namespace simt {

constexpr int P = 4;          // pixels of a thread's tile: one residue class mod s2
constexpr int CK = 32;        // channels a staged chunk
constexpr int ROWB = CK * 4;  // bytes a staged column: eight 16-byte quads
constexpr int MAX_THREADS = 384;
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 227 * 1024;

struct Plan {
  int nh;           // row pairs a block: 1 (rows y, y + s2) or 2 (4 rows, s2 apart)
  int nres;         // residue classes mod s2 a block takes: min(s2, 4)
  int rgroups;      // blocks a segment: ceil(s2 / nres)
  int nt;           // tiles: nres * J, J tiles a residue class
  int S;            // output pixels a block owns in each of its rows: nt * P
  int span;         // image columns a segment spans: P * J * s2
  int ng;           // dx groups of G
  int nc;           // staged f2 columns a row: nres * (P * J + D - 1)
  int rs;           // staged rows a row pair takes a pass
  int srs;          // staged f2 rows a stage: rs + 2 (nh - 1)
  int npass;        // passes over the D + 1 staged rows of a row pair
  int threads;      // rs * nh * ng * nt * (4 / nh), rounded up to whole warps
  int nst;          // ring stages
  int stage_out;    // output tiles in shared memory (else stored straight out)
  int stage_bytes;  // one ring stage: the f1 chunks of the rows, srs f2 row chunks
  int smem;
};

// Byte key of staged column c: its 16-byte quads q sit at q ^ key. The 8
// lanes of a 16-byte shared-load phase are 8 / NCS neighbouring tiles x NCS
// channel slices, and slice cs reads quad cs + NCS k, so the slices of a
// tile read one aligned block of NCS quads; the key, a multiple of NCS set
// by the tile whose pixels the column holds (f1) or first feeds (f2), puts
// the block of each of the 8 / NCS tiles elsewhere: 8 distinct bank groups.
// pn = P * nres.
template <int NCS>
__device__ __forceinline__ int swz(int c, int pn, int nres) {
  return ((((c / pn) * nres + c % nres) & (8 / NCS - 1)) * NCS) << 4;
}

// One step of a reduce-scatter over lanes l and l ^ lane_mask: the pair
// sums elements 2 i (lane with !hi) and 2 i + 1 (hi) of their first M, into
// acc[i]. Unrolled with constant indices, so acc stays in registers.
template <int M>
__device__ __forceinline__ void reduce_half(float* acc, bool hi, int lane_mask) {
#pragma unroll
  for (int i = 0; i < M / 2; ++i) {
    const float e0 = acc[2 * i], e1 = acc[2 * i + 1];
    acc[i] = (hi ? e1 : e0) + __shfl_xor_sync(0xffffffffu, hi ? e0 : e1, lane_mask);
  }
}

// A block owns S output pixels (nres residue classes of a segment) of R =
// 2 NH output rows y0 + r s2 and walks every displacement row: f2 row
// y0 - md + t s2 is displacement row t - r of row r, so D + R - 1 staged rows
// serve all R. A thread owns one row pair (rows 2h, 2h + 1), one staged row
// t = 2h + i (i <= D: displacement row i of row 2h and i - 1 of row 2h + 1),
// one group of G dx, one tile of P pixels (x_t + s2 p, p < P) and one of
// NCS = 4 / NH channel slices, and keeps 2 x P x G f32 sums: per 4 channels
// it reads 2 P f1 and P + G - 1 f2 values with 16-byte shared loads for
// 2 P G x 4 FMAs. At the end of a pass (all channels of its staged rows) the
// NCS slices of a tile are summed by shuffles. Units (pass, 32-channel
// chunk) are staged by cp.async into a ring.
template <int G, int NH>
__global__ void __launch_bounds__(MAX_THREADS)
corr_f32(const float* __restrict__ f1, const float* __restrict__ f2, float* __restrict__ out,
         int H, int W, int C, int md, int s2, int D, const Plan pl, int vec) {
  extern __shared__ __align__(128) char smem[];
  constexpr int NCS = 4 / NH;   // channel slices of a tile
  constexpr int NQ = 8 / NCS;   // quads of a chunk a slice reads
  constexpr int R = 2 * NH;     // output rows of a block
  constexpr int N = 2 * P * G;  // sums: (row r, dx ix, pixel p) at (r G + ix) P + p
  const int tid = threadIdx.x, cs = tid % NCS;
  int rest = tid / NCS;
  const int tile = rest % pl.nt;
  rest /= pl.nt;
  const int g = rest % pl.ng;  // dx group
  rest /= pl.ng;
  const int h = rest % NH, ii = rest / NH;  // row pair; staged row of the pass
  const bool live = ii < pl.rs;             // else a thread that rounds up a warp
  const int nres = pl.nres, pn = P * nres, S = pl.S;
  const int rho = tile % nres, j = tile / nres;
  const int seg = blockIdx.x / pl.rgroups;
  const int rho0 = (blockIdx.x - seg * pl.rgroups) * nres;  // first residue class
  const int x0 = seg * pl.span + rho0;  // image column of staged f1 column 0
  const int b = blockIdx.z;
  const int y0 = (blockIdx.y / s2) * R * s2 + blockIdx.y % s2;
  if (y0 >= H) return;  // block-uniform
  const int NR = D + R - 1, D2 = D * D;
  const int nck = (C + CK - 1) / CK, U = pl.npass * nck;
  const int f1_bytes = R * S * ROWB;
  char* ring = smem;
  float* osm = reinterpret_cast<float*>(smem + (size_t)pl.nst * pl.stage_bytes);

  // Staged column c holds image column xb + c % nres + s2 (c / nres): the
  // block's residue classes side by side (c = x - xb when nres = s2). Zeros
  // outside the map, past C and for residues >= s2; rows outside the map are
  // not staged (no thread reads them).
  auto issue = [&](int u) {
    if (u < U) {
      const int pass = u / nck, q = tid & 7, gc = (u - pass * nck) * CK + 4 * q;
      const int step = blockDim.x >> 3;
      char* st = ring + (size_t)(u % pl.nst) * pl.stage_bytes;
      // 16 bytes of image column x (residue res of the block) of row y
      auto copy = [&](const float* img, int y, int x, int res, char* dst) {
        const bool in = (unsigned)x < (unsigned)W && rho0 + res < s2;
        const float* p = in ? img + (((size_t)b * H + y) * W + x) * C + gc : img;
        if (vec) {
          cp_async16(smem_u32(dst), p, in && gc < C);
        } else {
          float v[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) v[e] = (in && gc + e < C) ? p[e] : 0.f;
          *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
        }
      };
      for (int i = tid >> 3; i < R * S; i += step) {  // f1 of the R output rows
        const int r = i / S, c = i - r * S, y = y0 + r * s2, res = c % nres;
        if (y < H)
          copy(f1, y, x0 + res + s2 * (c / nres), res,
               st + i * ROWB + ((q << 4) ^ swz<NCS>(c, pn, nres)));
      }
      for (int c = tid >> 3; c < pl.nc; c += step) {  // f2: a column of every row
        const int res = c % nres, x = x0 - md + res + s2 * (c / nres);
        char* dst = st + f1_bytes + c * ROWB + ((q << 4) ^ swz<NCS>(c, pn, nres));
        for (int rr = 0; rr < pl.srs; ++rr) {
          const int t = pass * pl.rs + rr, y = y0 - md + t * s2;
          if (t < NR && y >= 0 && y < H) copy(f2, y, x, res, dst + rr * pl.nc * ROWB);
        }
      }
    }
    cp_commit();  // possibly empty: keeps the group count uniform
  };
  for (int u = 0; u < pl.nst - 1; ++u) issue(u);

  // this thread's columns in a stage, and their byte keys
  const int c1 = rho + pn * j;                          // f1 column of pixel p: c1 + nres p
  const int k1 = ((tile & (NQ - 1)) * NCS) << 4;        // every f1 column of the tile
  const int gq = g * G;
  const int c2 = rho + nres * (P * j + gq);             // f2 column of n = p + ix: c2 + nres n
  const int nload = P + min(G, D - gq) - 1;             // f2 columns this group needs

  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
  for (int u = 0; u < U; ++u) {
    cp_wait(pl.nst - 2);  // unit u has landed
    __syncthreads();      // unit u visible to all; unit u - 1's stage free
    issue(u + pl.nst - 1);
    const int pass = u / nck;
    const int i = pass * pl.rs + ii, yy = y0 - md + (2 * h + i) * s2;
    if (live && i <= D && yy >= 0 && yy < H) {
      const char* st = ring + (size_t)(u % pl.nst) * pl.stage_bytes;
      const char* row1 = st + 2 * h * S * ROWB;
      const char* row2 = st + f1_bytes + (2 * h + ii) * pl.nc * ROWB;
#pragma unroll 1
      for (int k = 0; k < NQ; ++k) {
        const int kq = (cs + NCS * k) << 4;  // quad cs + NCS k
        float4 a[2][P];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int p = 0; p < P; ++p)
            a[r][p] = *reinterpret_cast<const float4*>(row1 + (r * S + c1 + nres * p) * ROWB +
                                                       (kq ^ k1));
#pragma unroll
        for (int n = 0; n < P + G - 1; ++n) {
          float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
          if (n < nload) {
            const int c = c2 + nres * n;
            // swz<NCS>(c): the tile of c is tile + nres ((gq + n) / P)
            const int key = (((tile + nres * ((gq + n) / P)) & (NQ - 1)) * NCS) << 4;
            v = *reinterpret_cast<const float4*>(row2 + c * ROWB + (kq ^ key));
          }
#pragma unroll
          for (int p = 0; p < P; ++p) {
            const int ix = n - p;
            if (ix < 0 || ix >= G) continue;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              float& s = acc[(r * G + ix) * P + p];
              s = fmaf(a[r][p].x, v.x, s);
              s = fmaf(a[r][p].y, v.y, s);
              s = fmaf(a[r][p].z, v.z, s);
              s = fmaf(a[r][p].w, v.w, s);
            }
          }
        }
      }
    }
    if (u - pass * nck == nck - 1) {  // the pass is done (block-uniform)
      // sum the NCS channel slices (lanes cs = tid % NCS) by a
      // reduce-scatter that leaves element NCS e + cs in acc[e]
      reduce_half<N>(acc, cs & 1, 1);
      if constexpr (NCS == 4) reduce_half<N / 2>(acc, cs & 2, 2);
      const float fc = (float)C;
#pragma unroll
      for (int e = 0; e < N / NCS; ++e) {
        // element NCS e + cs: pixel p, (r, ix) = (ri / G, ri % G)
        const int p = (NCS * e) % P + cs, ri = (NCS * e) / P;
        const int r = ri / G, ix = gq + ri % G, iy = i - r;
        const int row = 2 * h + r, y = y0 + row * s2, x = x0 + rho + s2 * (P * j + p);
        if (live && iy >= 0 && iy < D && ix < D && y < H && rho0 + rho < s2 && x < W) {
          const float val = acc[e] / fc;
          if (pl.stage_out)
            osm[(row * S + c1 + nres * p) * D2 + iy * D + ix] = val;
          else
            out[(((size_t)b * H + y) * W + x) * D2 + iy * D + ix] = val;
        }
      }
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = 0.f;
    }
  }

  if (pl.stage_out) {  // each output row's span of S D^2 values, coalesced
    __syncthreads();
    for (int r = 0; r < R; ++r) {
      const int y = y0 + r * s2;
      if (y >= H) break;
      float* o = out + (((size_t)b * H + y) * W + x0) * D2;
      const float* src = osm + r * S * D2;
      const int n = min(S, W - x0) * D2;
      for (int e = tid; e < n; e += blockDim.x) o[e] = src[e];
    }
  }
}

// Block geometry and shared memory of one launch; false if none fits.
bool plan(int s2, int D, int G, int B, int H, int W, Plan* pl) {
  if (s2 < 1 || D > 41) return false;
  Plan q;
  q.nres = s2 < 4 ? s2 : 4;
  q.rgroups = (s2 + q.nres - 1) / q.nres;
  const int J = (s2 == 1 ? 32 : 8) / P;  // S = 32 at s2 = 1, 8 nres else
  q.nt = q.nres * J;
  q.S = q.nt * P;
  q.span = P * J * s2;
  q.ng = (D + G - 1) / G;
  q.nc = q.nres * (P * J + D - 1);
  const int per_row = 4 * q.ng * q.nt;  // threads a staged row of every row pair
  const int rs_max = min(D + 1, MAX_THREADS / per_row);
  // 4 output rows a block where that leaves two blocks an SM (fewer staged
  // rows an output row: (D + 3) / 4 against (D + 1) / 2), else 2; output
  // tiles in shared memory where they fit beside a 2-stage ring; then as
  // many staged rows a pass as the threads and the ring allow
  const long long quads = (long long)B * ((W + q.span - 1) / q.span) * q.rgroups *
                          ((H + 4 * s2 - 1) / (4 * s2)) * s2;
  for (int nh = quads >= 2LL * sm_count() ? 2 : 1; nh >= 1; --nh) {
    const int R = 2 * nh;
    for (int so = q.rgroups == 1 ? 1 : 0; so >= 0; --so) {
      const int tile = so ? R * q.S * D * D * 4 : 0;
      for (int rs = rs_max; rs >= 1; --rs) {
        const int npass = (D + 1 + rs - 1) / rs;
        const int rows = (D + 1 + npass - 1) / npass;  // the passes balanced
        const int srs = rows + 2 * (nh - 1);
        const int stage = (R * q.S + srs * q.nc) * ROWB;
        if (tile + 2 * stage > MAX_SMEM) continue;
        q.nh = nh;
        q.rs = rows;
        q.srs = srs;
        q.npass = npass;
        q.threads = (rows * per_row + 31) / 32 * 32;
        q.stage_out = so;
        q.stage_bytes = stage;
        q.nst = min(MAX_STAGES, (MAX_SMEM - tile) / stage);
        q.smem = tile + q.nst * stage;
        *pl = q;
        return true;
      }
    }
  }
  return false;
}

template <int G, int NH>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                   int md, int s2, int D, const Plan& pl, bool vec, cudaStream_t stream) {
  auto kernel = corr_f32<G, NH>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + pl.span - 1) / pl.span * pl.rgroups,
                  (H + 2 * NH * s2 - 1) / (2 * NH * s2) * s2, B);
  kernel<<<grid, pl.threads, pl.smem, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2), static_cast<float*>(out),
      H, W, C, md, s2, D, pl, (int)vec);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                     int md, int s2, cudaStream_t stream) {
  const int D = 2 * (md / s2) + 1;
  const int G = D <= 9 ? 9 : 7;  // LiteFlowNetCorr: its 9 dx; FlowNetC: 3 groups of 7
  Plan pl;
  if (!plan(s2, D, G, B, H, W, &pl)) return cudaErrorInvalidValue;
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(f1) % 16 == 0 &&
                   reinterpret_cast<size_t>(f2) % 16 == 0;
  if (G == 9)
    return pl.nh == 2 ? launch<9, 2>(f1, f2, out, B, H, W, C, md, s2, D, pl, vec, stream)
                      : launch<9, 1>(f1, f2, out, B, H, W, C, md, s2, D, pl, vec, stream);
  return pl.nh == 2 ? launch<7, 2>(f1, f2, out, B, H, W, C, md, s2, D, pl, vec, stream)
                    : launch<7, 1>(f1, f2, out, B, H, W, C, md, s2, D, pl, vec, stream);
}

}  // namespace simt

// ------------------------------------------------------- bf16 tensor cores

namespace tc {

constexpr int THREADS = 256;  // 8 warps: 4 m-tiles x 2 groups
constexpr int NG = 2;         // warp groups
constexpr int KC = 64;        // channels per staged chunk
constexpr int MAX_NCK = 4;    // f1 fragments in registers: C <= 256
constexpr int ROWB = KC * 2;  // bytes per staged row: eight 16-byte chunks
constexpr int MAX_STAGES = 8;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int HALF_SMEM = 113 * 1024;  // two blocks an SM

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t* r) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}
// d += a (16x16 bf16, row) . b (16x8 bf16, col), f32 accumulators
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage nrow pixels of one image row (`rowp` points at its x = 0, channel 0)
// of a bf16 NHWC map, channels [c0, c0 + KC), into 128-byte rows of `dst`:
// row r holds pixel gx0 + r % e + s2 * (r / e) (gx0 + r when e = s2), its
// 16-byte chunk ch at position ch ^ ((r / e) & 7). The 8 rows one ldmatrix
// phase reads are e apart, so their keys differ and they land in 8 distinct
// bank groups. r / e is taken as (r * e_magic) >> 32, exact for these r.
// Zeros outside the map and past C; vec: 16-byte cp.async (C % 8 == 0,
// aligned map), else element-wise.
__device__ __forceinline__ void stage_rows(char* dst, const uint16_t* __restrict__ rowp,
                                           int gx0, int nrow, int W, int C, int c0, int s2,
                                           int e, uint64_t e_magic, bool vec, int tid) {
  const int ch = tid & 7, gc = c0 + ch * 8;
  for (int r = tid >> 3; r < nrow; r += THREADS / 8) {
    const int rq = (int)(((uint64_t)r * e_magic) >> 32);  // r / e
    char* d = dst + r * ROWB + ((ch ^ (rq & 7)) << 4);
    const int gx = gx0 + r + (s2 - e) * rq;
    const bool in_map = (unsigned)gx < (unsigned)W;
    const uint16_t* p = rowp + (ptrdiff_t)gx * C + gc;
    if (vec) {
      const bool ok = in_map && gc < C;
      cp_async16(smem_u32(d), ok ? p : rowp, ok);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = gc + 2 * j;
        const uint32_t lo = (in_map && c < C) ? p[2 * j] : 0u;
        const uint32_t hi = (in_map && c + 1 < C) ? p[2 * j + 1] : 0u;
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// The two warp groups of a block either share one output row and take
// alternate displacement rows (a pipeline unit stages 2 f2 rows), or, with
// `pair`, take output rows y0 and y0 + s2, for which f2 row y0 - md + t s2
// is displacement row t of the first and t - 1 of the second: a unit stages
// one f2 row that both use, so D + 1 staged rows serve 2 output rows instead
// of 2 D. Pairs halve the grid, so they come first only where it stays large.
//
// Pixels are staged in rows of stride e = min(s2, 4) per residue class. For
// s2 <= 4 the staged rows are the pixels in order, and a block owns S
// contiguous pixels. For s2 > 4 a segment of 16 s2 pixels holds s2 residue
// classes; a block takes 4 of them (blockIdx.x = segment * rgroups + group)
// and stages only their pixels, the 4 classes interleaved, so the product
// runs as at s2 = 4.
struct Geometry {
  int e;          // staged-row stride of a residue class: min(s2, 4)
  int rgroups;    // blocks a segment: ceil(s2 / 4) for s2 > 4, else 1
  int span;       // pixels a segment spans: S, or 16 s2 for s2 > 4
  int S;          // output pixels per block: 4 m-tiles of 16 (48 at s2 = 3)
  int NT;         // n-tiles per m-tile: ceil((15 + steps) / 8), rounded to 3, 5 or 7
  int ncol2;      // staged f2 rows per image row (a row slot: ncol2 x 128 bytes)
  int nck;        // 64-channel chunks
  int f1ring;     // C > 256: each unit stages its f1 chunk (else A fragments in registers)
  int pair;       // the groups take 2 output rows (else 2 displacement rows)
  int nst;        // ring stages
  int stage_out;  // output tile(s) in shared memory (else stored straight out)
  size_t smem;
};

// NCK 1..4 (C <= 256): the block's f1 chunks are staged once and kept as A
// fragments in registers. NCK 0 (any C): every pipeline unit stages its f1
// chunk beside its f2 rows, and the A fragments are read from it.
template <int NCK, int NT>
__global__ void __launch_bounds__(THREADS)
corr_bf16_tc(const uint16_t* __restrict__ f1, const uint16_t* __restrict__ f2,
             uint16_t* __restrict__ out, int H, int W, int C, int md, int s2, int steps,
             const Geometry g, uint64_t e_magic, int vec, float inv_c) {
  extern __shared__ __align__(128) char smem[];
  const int e = g.e, S = g.S;
  const int nck = NCK > 0 ? NCK : g.nck;
  const int slot_bytes = g.ncol2 * ROWB;  // one staged f2 row
  const int f1_bytes = S * ROWB;          // one staged f1 chunk of the block's pixels
  const int rps = g.pair ? 1 : NG;        // f2 rows a unit stages
  const int f1_rows = g.pair ? NG : 1;    // output rows of the block
  const int stage_bytes = rps * slot_bytes + (NCK == 0 ? f1_rows * f1_bytes : 0);
  char* ring = smem;  // g.nst stages
  uint16_t* osm = reinterpret_cast<uint16_t*>(smem + (size_t)g.nst * stage_bytes);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = warp >> 2;  // warp group
  const int mt = warp & 3;    // m-tile: staged rows base + e * i, i < 16
  const int seg = blockIdx.x / g.rgroups;
  const int xoff = 4 * (blockIdx.x - seg * g.rgroups);  // first residue class (s2 > 4)
  const int x0 = seg * g.span, b = blockIdx.z;
  // ybase: the row of f2's displacement 0 offset; this group's output row
  const int ybase = g.pair ? (blockIdx.y / s2) * 2 * s2 + blockIdx.y % s2 : blockIdx.y;
  const int y = ybase + (g.pair ? grp * s2 : 0);
  const int D2 = steps * steps;
  const int tile_elems = (S * D2 + 16 + 7) / 8 * 8;  // an output tile, 16-byte multiple
  const size_t row1 = ((size_t)b * H + (y < H ? y : 0)) * W;  // pixel index of (b, y, 0)
  const size_t e0 = (row1 + x0) * (size_t)D2;   // first output element of the tile
  const int shift = (int)(e0 & 7);              // tile[shift + j] <-> out[e0 + j]
  uint16_t* tile = osm + (g.pair ? grp * tile_elems : 0);
  const int base = (mt / e) * 16 * e + mt % e;
  const bool has_tile = mt < S / 16 && xoff + mt % e < s2 && y < H;
  const int lx0 = xoff + mt % e + s2 * (base / e);  // pixel of staged row base, from x0
  // ldmatrix rows of this lane: A rows i = lane & 15 (chunk + 1 for lanes
  // 16..31), B rows n = lane & 7 (chunk + 1 for lanes 8..15); every row a
  // lane addresses has swizzle key (row / e) & 7 = lane & 7
  const int key = lane & 7;
  const uint32_t a_row = (base + e * (lane & 15)) * ROWB, a_hi = lane >> 4;
  const uint32_t b_row = (base + e * (lane & 7)) * ROWB, b_hi = (lane >> 3) & 1;
  // chunk ck of the block's pixels in output row ybase + r s2
  auto stage_f1 = [&](char* dst, int r, int ck) {
    const int yr = ybase + r * s2;
    if (yr < H)
      stage_rows(dst, f1 + ((size_t)b * H + yr) * W * C, x0 + xoff, S, W, C, ck * KC, s2, e,
                 e_magic, vec, tid);
  };

  // NCK > 0: this group's f1 chunks -> A fragments in registers, through
  // the ring
  uint32_t a[NCK > 0 ? NCK * 4 : 1][4];
  if constexpr (NCK > 0) {
    for (int r = 0; r < f1_rows; ++r) {
#pragma unroll
      for (int ck = 0; ck < NCK; ++ck) stage_f1(ring + (size_t)(r * NCK + ck) * f1_bytes, r, ck);
    }
    cp_commit();
    cp_wait(0);
    __syncthreads();
#pragma unroll
    for (int ck = 0; ck < NCK; ++ck) {
      const uint32_t p =
          smem_u32(ring + (size_t)((g.pair ? grp * NCK : 0) + ck) * f1_bytes) + a_row;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        if (has_tile) ldsm_x4(p + (((2 * kk + a_hi) ^ key) << 4), a[ck * 4 + kk]);
    }
    __syncthreads();  // the ring is free again
  }

  // pipeline units (v, channel chunk): f2 rows t = v * rps + j, j < rps, at
  // ybase - md + t * s2 (t < steps, or t <= steps with pairs), and with
  // NCK 0 the chunk of f1
  const int nv = g.pair ? steps + 1 : (steps + NG - 1) / NG;
  const int U = nv * nck;
  auto issue = [&](int u) {
    if (u < U) {
      const int v = u / nck, ck = u - v * nck;
      char* st = ring + (size_t)(u % g.nst) * stage_bytes;
      for (int j = 0; j < rps; ++j) {
        const int t = v * rps + j, yy = ybase - md + t * s2;
        if (t < steps + g.pair && yy >= 0 && yy < H)
          stage_rows(st + j * slot_bytes, f2 + ((size_t)b * H + yy) * W * C, x0 + xoff - md,
                     g.ncol2, W, C, ck * KC, s2, e, e_magic, vec, tid);
      }
      if constexpr (NCK == 0) {
        for (int r = 0; r < f1_rows; ++r) stage_f1(st + rps * slot_bytes + r * f1_bytes, r, ck);
      }
    }
    cp_commit();  // possibly empty: keeps the group count uniform
  };
  for (int u = 0; u < g.nst - 1; ++u) issue(u);

  const int gq = lane >> 2, q = 2 * (lane & 3);  // accumulator row / column of this lane
  for (int v = 0; v < nv; ++v) {
    // this group's f2 row of the unit (sub-row jg) and its displacement row
    const int jg = g.pair ? 0 : grp;
    const int iy = g.pair ? v - grp : v * NG + grp;
    const int yy = ybase - md + (v * rps + jg) * s2;
    const bool active = has_tile && iy >= 0 && iy < steps && yy >= 0 && yy < H;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
#pragma unroll
    for (int ck = 0; ck < nck; ++ck) {
      const int u = v * nck + ck;
      cp_wait(g.nst - 2);  // unit u has landed
      __syncthreads();     // unit u visible to all; unit u - 1's stage free
      issue(u + g.nst - 1);
      if (active) {
        const char* st = ring + (size_t)(u % g.nst) * stage_bytes;
        const uint32_t bb = smem_u32(st + jg * slot_bytes) + b_row;
        const uint32_t pa =
            smem_u32(st + rps * slot_bytes + (g.pair ? grp : 0) * f1_bytes) + a_row;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          if (ck * KC + kk * 16 >= C) break;  // only zero channels left
          const uint32_t bk = bb + (((2 * kk + b_hi) ^ key) << 4);
          auto band = [&](const uint32_t* ak) {
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              uint32_t b0, b1;
              ldsm_x2(bk + nt * (8 * e * ROWB), b0, b1);
              mma_bf16(acc[nt], ak, b0, b1);
            }
          };
          if constexpr (NCK > 0) {
            band(a[ck * 4 + kk]);
          } else {
            uint32_t af[4];
            ldsm_x4(pa + (((2 * kk + a_hi) ^ key) << 4), af);
            band(af);
          }
        }
      }
    }
    // P[i][n] = acc: out[x_i, iy, n - i] for 0 <= n - i < steps, scaled by
    // 1/C in f32 and rounded to bf16 (rows out of the map give zeros)
    if (has_tile && iy >= 0 && iy < steps) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          const int i = gq + 8 * (k4 >> 1), ix = nt * 8 + q + (k4 & 1) - i;
          if ((unsigned)ix < (unsigned)steps) {
            const uint16_t val =
                __bfloat16_as_ushort(__float2bfloat16_rn(acc[nt][k4] * inv_c));
            const int lx = lx0 + s2 * i, k = iy * steps + ix;
            if (g.stage_out)
              tile[shift + lx * D2 + k] = val;
            else if (x0 + lx < W)
              out[(row1 + x0 + lx) * (size_t)D2 + k] = val;
          }
        }
      }
    }
  }

  if (g.stage_out) {  // each output row's span, 16-byte stores where whole
    __syncthreads();
    for (int r = 0; r < f1_rows; ++r) {
      const int yr = ybase + r * s2;
      if (yr >= H) break;
      const size_t f = (((size_t)b * H + yr) * W + x0) * (size_t)D2;
      const int sh = (int)(f & 7);
      const uint16_t* src = osm + r * tile_elems;
      const size_t n = (size_t)min(S, W - x0) * D2;
      const size_t first = f >> 3, last = (f + n + 7) >> 3;
      for (size_t v = first + tid; v < last; v += THREADS) {
        const size_t gidx = v << 3;
        const int sidx = (int)(gidx - (f - sh));
        if (gidx >= f && gidx + 8 <= f + n) {
          *reinterpret_cast<uint4*>(out + gidx) = *reinterpret_cast<const uint4*>(src + sidx);
        } else {
          for (int j = 0; j < 8; ++j)
            if (gidx + j >= f && gidx + j < f + n) out[gidx + j] = src[sidx + j];
        }
      }
    }
  }
}

// Block geometry and shared memory of one launch; false if none fits.
bool plan(int C, int s2, int steps, bool out_aligned, int B, int H, int W, Geometry* g) {
  if (s2 < 1 || steps > 41) return false;
  g->e = s2 < 4 ? s2 : 4;
  g->rgroups = s2 > 4 ? (s2 + 3) / 4 : 1;
  g->S = 16 * g->e * (4 / g->e);
  g->span = s2 > 4 ? 16 * s2 : g->S;
  const int nt = (15 + steps + 7) / 8;
  g->NT = nt <= 3 ? 3 : nt <= 5 ? 5 : 7;
  g->ncol2 = g->S - 16 * g->e + g->e * g->NT * 8;  // every band row of every m-tile
  g->nck = (C + KC - 1) / KC;
  g->f1ring = g->nck > MAX_NCK;
  const size_t slot = (size_t)g->ncol2 * ROWB, f1b = (size_t)g->S * ROWB;
  const size_t tile = ((size_t)g->S * steps * steps + 16 + 7) / 8 * 16;  // bf16
  // pairs first where they leave at least two blocks an SM
  const long long blocks_x = (long long)((W + g->span - 1) / g->span) * g->rgroups;
  const long long pair_blocks = B * blocks_x * ((H + 2 * s2 - 1) / (2 * s2)) * s2;
  const int first = pair_blocks >= 2LL * sm_count() ? 1 : 0;
  for (int t = 0; t < 2; ++t) {
    const int pair = t == 0 ? first : 1 - first;
    const int rows = pair ? NG : 1;
    const size_t stage = (pair ? 1 : NG) * slot + (g->f1ring ? rows * f1b : 0);
    // with A fragments in registers, the f1 chunks pass through the ring first
    const size_t f1_pre = g->f1ring ? 0 : rows * g->nck * f1b;
    const int min_st = max(2, (int)((f1_pre + stage - 1) / stage));
    const size_t tiles = rows * tile;
    const bool stage_out =
        out_aligned && g->rgroups == 1 && tiles + min_st * stage <= (size_t)MAX_SMEM;
    const size_t used = stage_out ? tiles : 0;
    // the deepest ring that keeps two blocks an SM if it can, else one block
    const size_t budget =
        used + max(min_st, 4) * stage <= (size_t)HALF_SMEM ? HALF_SMEM : MAX_SMEM;
    if (used + min_st * stage > budget) continue;
    g->pair = pair;
    g->stage_out = stage_out;
    g->nst = (int)min((size_t)MAX_STAGES, (budget - used) / stage);
    g->smem = used + g->nst * stage;
    return true;
  }
  return false;
}

template <int NCK, int NT>
cudaError_t launch(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                   int md, int s2, int steps, const Geometry& g, bool vec,
                   cudaStream_t stream) {
  auto kernel = corr_bf16_tc<NCK, NT>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)g.smem);
  if (e != cudaSuccess) return e;
  const int rows = g.pair ? (H + 2 * s2 - 1) / (2 * s2) * s2 : H;
  const dim3 grid((W + g.span - 1) / g.span * g.rgroups, rows, B);
  const uint64_t magic = ((1ull << 32) + g.e - 1) / g.e;
  kernel<<<grid, THREADS, g.smem, stream>>>(
      static_cast<const uint16_t*>(f1), static_cast<const uint16_t*>(f2),
      static_cast<uint16_t*>(out), H, W, C, md, s2, steps, g, magic, (int)vec,
      1.0f / (float)C);
  return cudaGetLastError();
}

template <int NCK>
cudaError_t dispatch_nt(const void* f1, const void* f2, void* out, int B, int H, int W,
                        int C, int md, int s2, int steps, const Geometry& g, bool vec,
                        cudaStream_t stream) {
  switch (g.NT) {
    case 3: return launch<NCK, 3>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    case 5: return launch<NCK, 5>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    case 7: return launch<NCK, 7>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const void* f1, const void* f2, void* out, int B, int H, int W, int C,
                     int md, int s2, cudaStream_t stream) {
  const int steps = 2 * (md / s2) + 1;
  Geometry g;
  if (!plan(C, s2, steps, reinterpret_cast<size_t>(out) % 16 == 0, B, H, W, &g))
    return cudaErrorInvalidValue;
  const bool vec = C % 8 == 0 && reinterpret_cast<size_t>(f1) % 16 == 0 &&
                   reinterpret_cast<size_t>(f2) % 16 == 0;
  if (g.f1ring) return dispatch_nt<0>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
  switch (g.nck) {
    case 1: return dispatch_nt<1>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    case 2: return dispatch_nt<2>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    case 3: return dispatch_nt<3>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    case 4: return dispatch_nt<4>(f1, f2, out, B, H, W, C, md, s2, steps, g, vec, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// ------------------------------------------------------------ backward (SIMT)

namespace bwd {

constexpr int P = 4;           // pixels of a warp's tile: one residue class mod s2
constexpr int RW = 2;          // output rows of a warp
constexpr int MAX_WARPS = 8;   // 2 row pairs x 4 tiles
constexpr int MAX_STAGES = 4;
constexpr int MAX_SMEM = 227 * 1024;
constexpr int HALF_SMEM = 113 * 1024;  // two blocks an SM

struct Plan {
  int nres;         // residue classes mod s2 a block takes: min(s2, 4)
  int rgroups;      // blocks a segment: ceil(s2 / nres)
  int nt;           // pixel tiles of a row pair: nres * J (4; 3 at s2 = 3)
  int span;         // image columns a segment spans: P * J * s2
  int ncol;         // staged feature columns a row: nres * (P * J + D - 1)
  int R;            // output rows of a block, s2 apart: 2 or 4
  int nck;          // channel chunks of 32 Q channels
  int nst;          // ring stages
  int feat_bytes;   // one staged feature row: ncol columns of 32 Q channels
  int stage_bytes;  // + every warp's weights: (R / RW) nt (P + D - 1) RW P floats
  int smem;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 4 channels of a staged column as f32: one 16-byte (f32) or 8-byte (bf16,
// widened here) shared load
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 ld4(const __nv_bfloat16* p) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}
// 4 consecutive outputs with one 16-byte (f32) or 8-byte (bf16) store
__device__ __forceinline__ void st4(float* p, float4 v) {
  __stcs(reinterpret_cast<float4*>(p), v);  // streaming: keeps the staged rows in L2
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  __stcs(reinterpret_cast<uint2*>(p),
         make_uint2(*reinterpret_cast<const uint32_t*>(&a), *reinterpret_cast<const uint32_t*>(&b)));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool ok) {
  // src-size 0 fills the 4 bytes with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void fma4(float4& a, float w, const float4& f) {
  a.x = fmaf(w, f.x, a.x);
  a.y = fmaf(w, f.y, a.y);
  a.z = fmaf(w, f.z, a.z);
  a.w = fmaf(w, f.w, a.w);
}

// Both input gradients in one form (grad_f2 is grad_f1's with g read through
// the mirrored index; e = 0 for grad_f1, 2 (md mod s2) for grad_f2):
//   out[y, x, c] = (1/C) sum_{jy, jx} w[y, x, jy, jx] feat[y - md + e + jy s2,
//                                                          x - md + e + jx s2, c]
//   grad_f1: feat = f2, w = g[y, x, jy D + jx]
//   grad_f2: feat = f1, w = g[y - md + e + jy s2, x - md + e + jx s2,
//                             D^2 - 1 - jy D - jx]
// The low bit of blockIdx.z picks which. A block owns R output rows y0 + r s2
// of S pixels (nres residue classes of a segment) and CB = 32 Q channels;
// staged feature row t (row y0 - md + e + t s2) is displacement row jy = t - r
// of output row r, so D + R - 1 staged rows serve all R. Warp (h, tile) owns
// output rows 2h and 2h + 1 and P pixels x_t + s2 p of one residue class,
// lane l channels 4 l + 128 q (q < Q / 4): RW x P x Q f32 sums. Per staged
// row its band is the P + D - 1 staged columns n = p + jx; column n's
// weights wd[n][row][p] = w[row][p][n - p] (zero off the band; not staged for
// a row the staged row does not feed, whose products are skipped) are staged
// by the warp itself, diagonally, so one column costs Q / 4 feature loads (a
// warp reads 512 contiguous bytes: no bank conflict) and RW broadcast weight
// loads for up to RW P Q FMAs.
template <typename T, int Q>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2)
corr_backward(const T* __restrict__ g, const T* __restrict__ f1, const T* __restrict__ f2,
              T* __restrict__ gf1, T* __restrict__ gf2, int H, int W, int C, int md, int s2,
              int D, const Plan pl, int vec) {
  extern __shared__ __align__(128) char smem[];
  constexpr int NQ = Q / 4;                     // quads of a lane
  constexpr int CB = 32 * Q;                    // channels of a chunk
  constexpr int COLB = CB * (int)sizeof(T);     // bytes of a staged column
  constexpr int V = 16 / (int)sizeof(T);        // elements of a 16-byte copy
  constexpr int CPC = COLB / 16;                // 16-byte copies of a column
  constexpr int WN = RW * P;                    // weights of a band column
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = warp % pl.nt, h = warp / pl.nt;
  const int nres = pl.nres, rho = tile % nres, j = tile / nres;
  const bool grad2 = blockIdx.z & 1;
  const int z = blockIdx.z >> 1, b = z / pl.nck, c0 = (z - b * pl.nck) * CB;
  const int seg = blockIdx.x / pl.rgroups;
  const int rho0 = (blockIdx.x - seg * pl.rgroups) * nres;  // first residue class
  const int R = pl.R;
  const int y0 = (blockIdx.y / s2) * R * s2 + blockIdx.y % s2;
  if (y0 >= H) return;  // block-uniform
  const int e = grad2 ? 2 * (md % s2) : 0;
  const int xb = seg * pl.span + rho0 - md + e;  // image column of staged column 0
  const int NB = P + D - 1, D2 = D * D, U = D + R - 1;
  const T* feat = grad2 ? f1 : f2;
  const int yr = y0 + RW * h * s2;                          // output row 2h (2h + 1: + s2)
  const int px = seg * pl.span + rho0 + rho + s2 * P * j;  // pixel p: px + s2 p
  const bool res_ok = rho0 + rho < s2;

  // Unit t: staged feature row t (warp w stages columns w, w + nwarps, ...;
  // staged column c holds image column xb + c % nres + s2 (c / nres), zeros
  // outside the map, past C and for residues >= s2) and each warp's diagonal
  // weights of that row. Rows outside the map are not staged (no warp reads
  // them). Lane l stages weights i = l + 32 k: row wr = (l / P) % RW and
  // pixel wp = l % P (fixed), jx = l / WN - wp + (32 / WN) k.
  const int nwarps = blockDim.x >> 5;
  const int sq = nwarps / nres, sr = nwarps - sq * nres;  // column step, as (c / nres, c % nres)
  const int cq0 = warp / nres, cr0 = warp - cq0 * nres;   // column warp, likewise
  const int wp = lane % P, wr = (lane / P) % RW, wx = px + s2 * wp;
  const int wy = yr + wr * s2;  // this lane's weight row and pixel
  // grad_f1: g[wy, wx, jy D + jx]; grad_f2: g[fy, xc, D^2 - 1 - jy D - jx] at
  // xc = wx - md + e + jx s2; jx = jx0 + KS k for the lane's k-th weight
  constexpr int KS = 32 / WN;
  const int jx0 = lane / WN - wp, xc0 = wx - md + e + jx0 * s2;
  const T* gw = grad2 ? g + ((ptrdiff_t)b * H * W + xc0) * D2 + D2 - 1 - jx0
                      : g + (((ptrdiff_t)b * H + wy) * W + wx) * D2 + jx0;
  const ptrdiff_t gstep = grad2 ? (ptrdiff_t)KS * s2 * D2 - KS : KS;
  const bool wok = res_ok && wy < H && (grad2 || wx < W);
  auto issue = [&](int t, int stage) {
    const int fy = y0 - md + e + t * s2;
    if (t < U && fy >= 0 && fy < H) {
      char* st = smem + (size_t)stage * pl.stage_bytes;
      const T* rowp = feat + ((size_t)b * H + fy) * W * C;
      int cq = cq0, cr = cr0;
      for (int col = warp; col < pl.ncol; col += nwarps) {
        const int x = xb + cr + s2 * cq;
        const bool in = (unsigned)x < (unsigned)W && rho0 + cr < s2;
        const T* src = rowp + (size_t)x * C;
        char* dst = st + col * COLB;
        for (int k = lane; k < CPC; k += 32) {
          const int gc = c0 + k * V;
          if (vec) {
            const bool ok = in && gc < C;
            cp_async16(smem_u32(dst + k * 16), ok ? src + gc : rowp, ok);
          } else {
            __align__(16) T v[V];
#pragma unroll
            for (int q = 0; q < V; ++q) v[q] = (in && gc + q < C) ? src[gc + q] : from_f<T>(0.f);
            *reinterpret_cast<uint4*>(dst + k * 16) = *reinterpret_cast<const uint4*>(v);
          }
        }
        cr += sr;
        cq += sq;
        if (cr >= nres) {
          cr -= nres;
          ++cq;
        }
      }
      // the weights of this lane's row, if the staged row feeds it (no
      // product reads those of a row it does not feed)
      const int jy = t - RW * h - wr;
      if (wok && jy >= 0 && jy < D) {
        float* wd = reinterpret_cast<float*>(st + pl.feat_bytes) + warp * NB * WN;
        const T* gp = gw + (grad2 ? (ptrdiff_t)fy * W * D2 - jy * D : (ptrdiff_t)jy * D);
        int jx = jx0, xc = xc0;
        for (int i = lane; i < NB * WN; i += 32, jx += KS, xc += KS * s2, gp += gstep) {
          const bool ok = jx >= 0 && jx < D && (!grad2 || (unsigned)xc < (unsigned)W);
          if constexpr (sizeof(T) == 4) {
            cp_async4(smem_u32(wd + i), ok ? gp : g, ok);
          } else {
            wd[i] = ok ? to_f(*gp) : 0.f;
          }
        }
      }
    }
    cp_commit();  // possibly empty: keeps the group count uniform
  };
  for (int t = 0; t < pl.nst - 1; ++t) issue(t, t);

  float4 acc[RW][P][NQ];
#pragma unroll
  for (int r = 0; r < RW; ++r)
#pragma unroll
    for (int p = 0; p < P; ++p)
#pragma unroll
      for (int q = 0; q < NQ; ++q) acc[r][p][q] = make_float4(0.f, 0.f, 0.f, 0.f);
  const int cstep = nres * COLB;                   // bytes between band columns
  const int cfirst = (rho + nres * P * j) * COLB;  // band column 0
  int stage = 0, next = pl.nst - 1;  // ring stages of units t and t + nst - 1
  for (int t = 0; t < U; ++t) {
    cp_wait(pl.nst - 2);  // unit t has landed
    __syncthreads();      // unit t visible to all; unit t - 1's stage free
    issue(t + pl.nst - 1, next);
    next = next + 1 == pl.nst ? 0 : next + 1;
    const int jy = t - RW * h, fy = y0 - md + e + t * s2;
    // rows 2h and 2h + 1 take displacement rows jy and jy - 1 of staged row t
    const bool a0 = jy >= 0 && jy < D && yr < H;
    const bool a1 = jy >= 1 && jy <= D && yr + s2 < H;
    if ((a0 || a1) && fy >= 0 && fy < H) {  // warp-uniform
      const char* st = smem + (size_t)stage * pl.stage_bytes;
      const char* fb = st + cfirst + lane * 4 * (int)sizeof(T);
      const float* wd = reinterpret_cast<const float*>(st + pl.feat_bytes) + warp * NB * WN;
      // the band of the active rows (ROWS: bit r for row r) in three parts, so
      // that only the products of the ramps' pixels issue: n < P - 1 feeds
      // pixels p <= n; P - 1 <= n < D every pixel; n = D - 1 + m (m >= 1)
      // pixels p >= m
      auto band = [&](auto rows) {
        constexpr int ROWS = decltype(rows)::value;
        auto column = [&](int n, int plo, int phi) {
          const T* c = reinterpret_cast<const T*>(fb + n * cstep);
          float4 f[NQ];
#pragma unroll
          for (int q = 0; q < NQ; ++q) f[q] = ld4(c + 128 * q);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            if (!(ROWS >> r & 1)) continue;
            const float4 w4 = *reinterpret_cast<const float4*>(wd + n * WN + r * P);
            const float w[P] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
            for (int p = 0; p < P; ++p)
              if (p >= plo && p <= phi)
#pragma unroll
                for (int q = 0; q < NQ; ++q) fma4(acc[r][p][q], w[p], f[q]);
          }
        };
#pragma unroll
        for (int n = 0; n < P - 1; ++n) column(n, 0, n);
#pragma unroll 1
        for (int n = P - 1; n < D; ++n) column(n, 0, P - 1);
#pragma unroll
        for (int m = 1; m < P; ++m)
          if (D - 1 + m >= P - 1) column(D - 1 + m, m, P - 1);  // else: the first part's
      };
      if (a0 && a1)
        band(std::integral_constant<int, 3>());
      else if (a0)
        band(std::integral_constant<int, 1>());
      else
        band(std::integral_constant<int, 2>());
    }
    stage = stage + 1 == pl.nst ? 0 : stage + 1;
  }

  if (!res_ok) return;
  const float fc = (float)C;
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (yr + r * s2 >= H) break;
    T* out = (grad2 ? gf2 : gf1) + ((size_t)b * H + yr + r * s2) * W * C;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int x = px + s2 * p;
      if (x >= W) break;
#pragma unroll
      for (int q = 0; q < NQ; ++q) {
        const int c = c0 + 128 * q + 4 * lane;
        const float4 a = acc[r][p][q];
        const float4 v = make_float4(a.x / fc, a.y / fc, a.z / fc, a.w / fc);
        T* o = out + (size_t)x * C + c;
        if (vec && c + 3 < C) {
          st4(o, v);
        } else {
          const float sv[4] = {v.x, v.y, v.z, v.w};
          for (int i = 0; i < 4 && c + i < C; ++i) o[i] = from_f<T>(sv[i]);
        }
      }
    }
  }
}

// Block geometry and shared memory of one launch; false if none fits.
bool plan(int Q, int esize, int budget, int C, int s2, int D, int B, int H, int W, Plan* pl) {
  if (s2 < 1 || D > 41) return false;
  Plan q;
  q.nres = s2 < 4 ? s2 : 4;
  q.rgroups = (s2 + q.nres - 1) / q.nres;
  const int J = q.nres == 3 ? 1 : 4 / q.nres;  // 16 pixels a row (12 at s2 = 3)
  q.nt = q.nres * J;
  q.span = P * J * s2;
  q.ncol = q.nres * (P * J + D - 1);
  q.nck = (C + 32 * Q - 1) / (32 * Q);
  if ((long long)B * q.nck * 2 > 65535) return false;
  q.feat_bytes = q.ncol * 32 * Q * esize;
  const long long cols = (long long)B * q.nck * 2 * ((W + q.span - 1) / q.span) * q.rgroups;
  // 4 output rows a block (3 staged rows an output row at D = 9, against
  // 5 with 2) where the grid still fills the card, else 2; a ring of at
  // least 2 stages in the budget of shared memory
  for (int R = 4; R >= RW; R /= 2) {
    const long long blocks = cols * ((H + R * s2 - 1) / (R * s2)) * s2;
    if (R > RW && blocks < 2 * sm_count()) continue;
    const int stage = q.feat_bytes + R * q.nt * (P + D - 1) * P * 4;
    if (2 * stage > budget) continue;
    q.R = R;
    q.stage_bytes = stage;
    q.nst = min(MAX_STAGES, budget / stage);
    q.smem = q.nst * stage;
    *pl = q;
    return true;
  }
  return false;
}

template <typename T, int Q>
cudaError_t launch(const void* g, const void* f1, const void* f2, void* gf1, void* gf2,
                   int B, int H, int W, int C, int md, int s2, int D, const Plan& pl,
                   bool vec, cudaStream_t stream) {
  auto kernel = corr_backward<T, Q>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pl.smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((W + pl.span - 1) / pl.span * pl.rgroups,
                  (H + pl.R * s2 - 1) / (pl.R * s2) * s2, B * pl.nck * 2);
  kernel<<<grid, 32 * pl.R / RW * pl.nt, pl.smem, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<T*>(gf1), static_cast<T*>(gf2), H, W, C, md, s2, D, pl, (int)vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* g, const void* f1, const void* f2, void* gf1, void* gf2,
                     int B, int H, int W, int C, int md, int s2, cudaStream_t stream) {
  const int D = 2 * (md / s2) + 1;
  constexpr int V = 16 / (int)sizeof(T);
  const bool vec = C % V == 0 && reinterpret_cast<size_t>(f1) % 16 == 0 &&
                   reinterpret_cast<size_t>(f2) % 16 == 0 &&
                   reinterpret_cast<size_t>(gf1) % 16 == 0 &&
                   reinterpret_cast<size_t>(gf2) % 16 == 0;
  // two blocks an SM (one's barriers and stores overlap the other's work)
  // before one; 256 channels a block where C needs them, else 128
  Plan pl;
  for (const int budget : {HALF_SMEM, MAX_SMEM}) {
    if (C > 128 && plan(8, sizeof(T), budget, C, s2, D, B, H, W, &pl))
      return launch<T, 8>(g, f1, f2, gf1, gf2, B, H, W, C, md, s2, D, pl, vec, stream);
    if (plan(4, sizeof(T), budget, C, s2, D, B, H, W, &pl))
      return launch<T, 4>(g, f1, f2, gf1, gf2, B, H, W, C, md, s2, D, pl, vec, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace bwd

}  // namespace

// f1, f2: (B, H, W, C) contiguous, f32 (is_bf16 = 0: the SIMT kernel) or
// bf16 (is_bf16 = 1: the tensor-core kernel); out: (B, H, W, D^2) of the
// same dtype. Returns cudaGetLastError() of the launch (0 = success), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int vps_correlation_forward(const void* f1, const void* f2, void* out,
                                       int B, int H, int W, int C, int md, int s2,
                                       int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || md < 0 || s2 <= 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? tc::dispatch(f1, f2, out, B, H, W, C, md, s2, st)
                                : simt::dispatch(f1, f2, out, B, H, W, C, md, s2, st);
  return (int)e;
}

// g: (B, H, W, D^2); f1, f2: (B, H, W, C); grad_f1, grad_f2: (B, H, W, C),
// all contiguous and of one dtype, f32 (is_bf16 = 0) or bf16 (is_bf16 = 1).
// One launch computes both gradients. Returns cudaGetLastError() of the
// launch, or cudaErrorInvalidValue for a geometry the kernel does not take.
extern "C" int vps_correlation_backward(const void* g, const void* f1, const void* f2,
                                        void* grad_f1, void* grad_f2, int B, int H, int W,
                                        int C, int md, int s2, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || md < 0 || s2 <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? bwd::dispatch<__nv_bfloat16>(g, f1, f2, grad_f1, grad_f2, B, H, W, C, md, s2, st)
              : bwd::dispatch<float>(g, f1, f2, grad_f1, grad_f2, B, H, W, C, md, s2, st);
  return (int)e;
}

extern "C" const char* vps_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
