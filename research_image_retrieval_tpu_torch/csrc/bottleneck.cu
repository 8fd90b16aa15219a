// Inference stride-1 identity bottleneck with folded batch norm, on
// Hopper's tensor cores at fp32 accuracy (3xTF32).
//
// Replaces: research_image_retrieval_tpu/ops/resblock_pallas.py
//           pallas_fused_bottleneck (the Pallas TPU kernel).
//
// Computes, on NHWC fp32 activations x [B, H, W, C] with Cw = C / 4:
//   t1  = relu(x @ w1 * s1 + b1), zeroed outside each image's extents
//   t2  = relu(conv3x3_same(t1, w2) * s2 + b2)
//   out = relu(t2 @ w3 * s3 + b3 + x)
// (s, b) are rows of the [2, C'] folded-BN arrays.  With extents [B, 2]
// the conv1 output is zeroed outside [0, ext_h) x [0, ext_w), which is
// what the JAX BottleneckBlock does on masked buckets
// (models/backbone.py:184-188); the TPU kernel zeroed only rows outside
// [0, H), so it could not serve the bucketed main path.  Without extents
// it equals the TPU kernel.
//
// What bounds it on an H100: operations.  One ResNet-50 identity block
// does 2 * M * (2 * C * Cw + 9 * Cw^2) FLOP (M = B * H * W pixels) on
// 8 * M * C bytes (x in, out back): ~0.27 * C FLOP per byte, 68 in layer1
// and more deeper.  The port keeps fp32 numerics (the golden descriptors
// hold to 1e-4 over 16 blocks; one TF32 product per fp32 product errs by
// ~1e-3 at these K), so every product is taken as three TF32 products:
// each operand v splits into big = rna_tf32(v) and small = rna_tf32(v -
// big), and small*big + big*small + big*big accumulate in fp32
// (small*small, below fp32's last bit, is dropped).  The ceiling is 495 /
// 3 = 165 TFLOP/s of fp32-accurate products against 3.35 TB/s: ~49 FLOP
// per byte, so the deeper layers are operations bound and layer1 sits
// near the ridge;
// with the chain's own traffic (the t1 / t2 round trips and the residual
// read again, ~16 * M * C bytes) layer1 falls below it, to ~34.
//
// Design: a chain of three launches of one implicit GEMM through two
// device scratch buffers (t1, t2; each a quarter of x).  Rows are pixels,
// columns output channels, and the weights are the B operand, K-major
// ([N, K]), split on the host into a [2, N, K] (big, small) pair once per
// parameter version.  A CTA computes 128 x BN output tiles (BN = 128, or
// 64 where N = 64):
//   - two consumer warpgroups issue wgmma.mma_async m64nBNk8 .tf32 with
//     A from registers (where the activations are split: 2 cvt and 1
//     subtraction per element) and B from shared memory (128-byte
//     swizzled, the layout wgmma reads without bank conflicts);
//   - one producer warpgroup fills a ring of 4 shared-memory stages with
//     16-byte cp.async, each stage 32 deep in K (one 128-byte row per
//     pixel or channel), and signals a "full" mbarrier per stage through
//     cp.async.mbarrier.arrive; consumers release a stage on its "empty"
//     mbarrier once the wgmma group that read it has retired.
//   - The tensor cores truncate each sum into their fp32 accumulator, a
//     drift that grows linearly with K and at K = 2048 comes within
//     reach of the 1e-4 error bar.  So each stage's 12 wgmmas sum its
//     32-deep slice from zero, and the CUDA cores add that partial into
//     the real accumulator with fp32 rounding.  While one stage's
//     products run, the next stage's A fragments are loaded and split;
//     setmaxnreg moves registers from the producer to the consumers for
//     the two sets of accumulators and fragments.
// Conv2 gathers its A operand on the fly (im2col is never written): K =
// 9 * Cw runs over (tap, channel), a 32-deep stage never straddles a tap,
// and taps outside the image, like rows beyond M, are zero-filled by the
// copy itself (src-size 0).  The epilogue applies the folded BN, the
// residual (read from device memory), the ReLU and the extents mask
// before one store.
//
// Schedule: persistent stream-K (Osama et al., PPoPP 2023, in its hybrid
// of data-parallel tiles and a stream-K region).  The ring takes ~197
// KB, so an SM holds one CTA, and a grid of tiles left SMs idle through a
// partial last wave (72 tiles on 132 SMs, say) and refilled the ring from
// empty for every tile.  Instead a launch starts min(#SMs, work) CTAs,
// each walking a static, contiguous share of the launch's (tile, K-stage)
// space; the plan (stream_k.h make_plan) is computed on the host from (M,
// N, K, SM count) and passed by value:
//   - of T tiles, R = T % #SMs fill a partial wave.  Where a whole wave
//     exists, the partial wave and the last whole wave (R + #SMs tiles)
//     are split along K evenly over all CTAs, 1-2 tiles' stages each;
//     the other whole waves stay whole, dealt round robin.  Where none
//     does, the R tiles are split over min(#SMs, R * KT / 4) CTAs, so no
//     CTA takes fewer than 4 stages, where that is more CTAs than tiles.
//   - A split is taken only where its busiest CTA, charged 4 stages for
//     the fixup, still finishes before the whole tiles' last wave would:
//     so tiles of fewer than 8 stages (K < 256), waves all but full, and
//     whole waves (the kernel is then a plain persistent GEMM) stay whole.
//   - Why the last whole wave joins the split: a fixup reads its shares
//     one after another (each about a stage-time), and the partial
//     wave alone, spread over all SMs, gave a tile up to 11 holders (12
//     tiles of 72 stages on 132 CTAs); with one whole wave more a tile
//     has 2-3.
//   - A CTA does its split share first, then its whole tiles.  The
//     producer goes straight on to the next unit's stages, so the ring
//     runs across tile boundaries: the next tile's loads, and the split
//     of its first A fragments, overlap this tile's epilogue, and only a
//     CTA's first tile starts from an empty ring (full / empty phases
//     count on across units).
// Fixup of a split tile, deterministic and without atomics in any sum:
// a CTA holding a later share writes its fp32 acc (the sum of its
// promoted stage partials) to its workspace slot and sets its flag
// (release); the CTA holding the tile's first stage waits for each later
// CTA's flag (acquire), resets it, and adds the shares in ascending K
// order before the epilogue.  A CTA holds a later share of at most one
// tile (the first in its range), so one slot and one flag per CTA do.
// The first share of a tile is the last unit of its CTA's split range
// and the later shares come first in theirs, so waits are short.  A CTA
// waits only on CTAs with a higher blockIdx, which hold no wait before
// they publish.  This assumes every CTA of the grid becomes resident:
// the grid never exceeds the SM count and an SM holds one CTA; a kernel
// of another stream (NCCL in rank-sharded extraction) can hold an SM for
// a while, which only delays a wait, because no CTA waits on a lower one.
// Where the tiles are balanced, what bounds the kernel is the per-stage
// work of the 3xTF32 form itself: 12 wgmmas on 32 K, the A split on the
// CUDA cores and the fp32 promotion of every stage (on an H100 a full
// wave runs at ~56% of the 3xTF32 peak; the index benchmark's blocks
// read ~48% of their roofline, ~42% before this schedule, when ~18% of
// the SM-time went to partial waves), and for the widest 1x1s the feed
// from L2.  BM stays 128: a 64-row CTA has one consumer warpgroup and ran
// at ~0.6x the rate; the schedule balances the SMs instead of smaller
// tiles.  Splitting K adds one fp32 addition per share: the same
// products at the same precision, and a given (M, N, K, SM count)
// always sums in the same order, so results repeat bit for bit.
//
// bf16 form (rir_fused_bottleneck_bf16): what the TPU kernel computes at
// dt = bf16 (resblock_pallas.py:84-100, 112-153): products of bf16 values
// accumulated in fp32, the folded BN and the residual in fp32, and t1, t2
// and out rounded to bf16 (round to nearest even).  The same pipeline
// with bf16 operands: a 128-byte stage row holds 64 bf16 values of K, and
// each stage is four wgmma.mma_async m64nBNk16 .f32.bf16.bf16 with A and
// B both read from shared memory (128-byte swizzle, K-major).  One
// product per slice: no split, and the accumulator carries the whole K
// (its truncation is far below bf16's rounding).  The weights are bf16
// K-major [N, K], rounded once per weight tensor by the wrapper; t1 and
// t2 are bf16.  At bf16 the tensor cores' dense 989 TFLOP/s against
// 3.35 TB/s puts the ridge at ~295 FLOP per byte, and a block does ~0.53
// * C FLOP per byte of x and out (2 bytes each): layer1 (C = 256, ~135)
// and layer2 (~270) sit below it, so at bf16 the chain is bytes bound
// in the early layers.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "stream_k.h"

namespace {

using stream_k::kBK;          // K depth of one fp32 stage: 128 bytes
constexpr int kStages = 4;    // shared-memory ring

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT_LOOP:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT_LOOP;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(bar) : "memory");
}

// 16-byte copy; zero-fills the destination when `valid` is false.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

// Round to TF32 (10 mantissa bits, nearest, ties away), low bits zeroed.
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r & 0xffffe000u;
}

// wgmma matrix descriptor of a K-major tile with 128-byte swizzle: rows of
// 128 bytes, 8-row atoms of 1024 bytes (stride byte offset), atoms
// 1024-byte aligned so the base offset is 0.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// Tell the compiler the accumulators change here (orders them around the
// asynchronous wgmma that the compiler cannot see into).
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] += A[64 x 8] (registers) * B[8 x 64] (shared, K-major), tf32.
__device__ __forceinline__ void wgmma_n64(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] += A[64 x 8] (registers) * B[8 x 128] (shared, K-major), tf32.
__device__ __forceinline__ void wgmma_n128(float* d, const uint32_t* a, uint64_t desc_b,
                                          int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float* d, const uint32_t* a, uint64_t desc_b,
                                           int scale_d) {
  if constexpr (BN == 128) {
    wgmma_n128(d, a, desc_b, scale_d);
  } else {
    wgmma_n64(d, a, desc_b, scale_d);
  }
}

using stream_k::kBM;
using stream_k::Plan;

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM * 128 + 2 * BN * 128) + 2 * kStages * 8 + 1024;
}

// The 256 consumer threads' own barrier (the producer never joins it).
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;" ::: "memory");
}

// Every thread polls `f` until it is set; the warp leaves the loop
// together, so the consumers' code stays convergent (a divergent wait
// cost the main loop its uniform registers: each wgmma descriptor then
// went through R2UR).
__device__ __forceinline__ void flag_wait(const int* f) {
  int v;
  do {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];" : "=r"(v) : "l"(f) : "memory");
  } while (!__all_sync(0xffffffffu, v != 0));
}

// *f = v, release, by the threads where `first` holds (a predicated
// store, no branch).
__device__ __forceinline__ void flag_release(int* f, int v, bool first) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n@p st.release.gpu.global.b32 [%0], %1;\n}" ::"l"(f),
      "r"(v), "r"(static_cast<int>(first))
      : "memory");
}

// out[m, n] = epilogue(sum_k A[m, k] * Wt[n, k]).  TAP3: A is the 3x3
// SAME im2col of an [M, Cin] NHWC map (K = 9 * Cin); else A is [M, K].
// Wt: [2, N, K] (tf32 big, tf32 small).  resid [M, N] or null; extents
// [B, 2] or null.  CTA: 2 consumer warpgroups + 1 producer warpgroup,
// walking the units `p` gives it.  ws: one 128 x BN fp32 slot per CTA;
// flags: one int per CTA, 0 between launches.
template <int BN, bool TAP3>
__global__ void __launch_bounds__(384, 1)
conv_gemm_tf32x3(const float* __restrict__ A, const float* __restrict__ Wt,
                 const float* __restrict__ sb, const float* __restrict__ resid,
                 const int* __restrict__ extents, float* __restrict__ out, int M, int K,
                 int N, int H, int W, int Cin, const Plan p, float* ws, int* flags) {
  constexpr int A_BYTES = kBM * 128;
  constexpr int B_BYTES = BN * 128;  // one half (big or small)
  constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint8_t* smem = smem_raw + (sbase - raw);
  const uint32_t full0 = sbase + kStages * STAGE_BYTES;  // kStages "full" mbarriers
  const uint32_t empty0 = full0 + 8 * kStages;           // kStages "empty" mbarriers

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int HW = H * W;

  if (wg == 2) {
    // ---- producer warpgroup: 16-byte chunk `chunk` of rows row0 + 16 i ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    // each role walks the units itself, after setmaxnreg, in its own registers
    stream_k::Units units(p, blockIdx.x);
    int tile, k0, k1;
    unsigned pos = 0;  // ring position: the stages this CTA has passed through the ring
    const int pt = tid - 256;
    const int chunk = pt & 7;
    const int row0 = pt >> 3;
    constexpr int AR = kBM / 16;
    constexpr int BR = BN / 16;
    const int half = N * K;
    while (units.next(p, tile, k0, k1)) {
      const int tm = tile / p.tiles_n;
      const int m0 = tm * kBM;
      const int n0 = (tile - tm * p.tiles_n) * BN;
      // 32-bit offsets from one row pointer per operand keep the producer
      // within the registers it gives up to the consumers
      const float* a_row = A + static_cast<long long>(m0 + row0) * Cin + chunk * 4;
      const float* w_row = Wt + static_cast<long long>(n0 + row0) * K + chunk * 4;
      int ahw[AR];  // (h << 16) | w of each row, for the 3x3 taps
      if constexpr (TAP3) {
#pragma unroll
        for (int i = 0; i < AR; ++i) {
          const int rem = (m0 + row0 + 16 * i) % HW;
          ahw[i] = ((rem / W) << 16) | (rem % W);
        }
      }
      for (int kt = k0; kt < k1; ++kt, ++pos) {
        if constexpr (TAP3) {
          // keep (h, w) packed: unpacked ahead of the loop they take 8
          // more of the producer's 40 registers and spill
#pragma unroll
          for (int i = 0; i < AR; ++i) asm volatile("" : "+r"(ahw[i]));
        }
        const int s = pos % kStages;
        mbar_wait(empty0 + 8 * s, ((pos / kStages) & 1) ^ 1);
        const int kk0 = kt * kBK;
        const uint32_t sa = sbase + s * STAGE_BYTES;
        int dy = 1, dx = 1, ci = kk0;
        if (TAP3) {
          const int tap = kk0 / Cin;
          ci = kk0 - tap * Cin;
          dy = tap / 3;
          dx = tap - 3 * dy;
        }
        const int tap_off = ((dy - 1) * W + (dx - 1)) * Cin + ci;
#pragma unroll
        for (int i = 0; i < AR; ++i) {
          const int r = row0 + 16 * i;
          bool ok = m0 + r < M;
          if constexpr (TAP3) {
            const int hh = (ahw[i] >> 16) + dy - 1;
            const int ww = (ahw[i] & 0xffff) + dx - 1;
            ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
          }
          const float* src = ok ? a_row + (16 * i * Cin + tap_off) : A;
          cp_async16(sa + r * 128 + ((chunk ^ (r & 7)) << 4), src, ok);
        }
        const uint32_t sb_big = sa + A_BYTES;
#pragma unroll
        for (int i = 0; i < BR; ++i) {
          const int r = row0 + 16 * i;
          const uint32_t off = r * 128 + ((chunk ^ (r & 7)) << 4);
          const float* src = w_row + (16 * i * K + kk0);
          cp_async16(sb_big + off, src, true);
          cp_async16(sb_big + B_BYTES + off, src + half, true);
        }
        cp_async_mbar_arrive(full0 + 8 * s);
      }
    }
  } else {
    // ---- consumer warpgroup wg: output rows wg * 64 .. + 63 of each tile ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
    stream_k::Units units(p, blockIdx.x);
    int tile, k0, k1;
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ra = wg * 64 + warp * 16 + g;  // this thread's A rows: ra, ra + 8
    // `part`: one stage's products, from zero; `acc`: their fp32 sum
    // (the tensor cores truncate; see the note at the top)
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.f;
    fence_regs(part);

    // Wait for ring position q and split its A fragments: (row, k) = (g,
    // t), (g + 8, t), (g, t + 4), (g + 8, t + 4) of each 8-deep step kk.
    auto load = [&](unsigned q, uint32_t (&big)[4][4], uint32_t (&small)[4][4]) {
      const int s = q % kStages;
      mbar_wait(full0 + 8 * s, (q / kStages) & 1);
      const float* a0 = reinterpret_cast<const float*>(smem + s * STAGE_BYTES + ra * 128);
      const float* a1 = a0 + 8 * 32;  // row ra + 8 (same swizzle phase: (ra + 8) & 7 == g)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int c0 = (((2 * kk) ^ g) << 2) + t;
        const int c1 = (((2 * kk + 1) ^ g) << 2) + t;
        const float v[4] = {a0[c0], a1[c0], a0[c1], a1[c1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          big[kk][j] = tf32_rna(v[j]);
          small[kk][j] = tf32_rna(v[j] - __uint_as_float(big[kk][j]));
        }
      }
    };
    // Issue position q's 12 products into `part`.
    auto mma = [&](unsigned q, const uint32_t (&big)[4][4], const uint32_t (&small)[4][4]) {
      const int s = q % kStages;
      // the stage was written by cp.async (generic proxy); wgmma reads B
      // through the async proxy
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t sb_big = sbase + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t db = desc_sw128(sb_big + 32 * kk);
        const uint64_t ds = desc_sw128(sb_big + B_BYTES + 32 * kk);
        wgmma_tile<BN>(part, small[kk], db, kk > 0);
        wgmma_tile<BN>(part, big[kk], ds, 1);
        wgmma_tile<BN>(part, big[kk], db, 1);
      }
      wgmma_commit();
    };
    // Wait for them, release the stage and add `part` into `acc`.
    auto retire = [&](unsigned q) {
      wgmma_wait<0>();
      fence_regs(part);
      mbar_arrive(empty0 + 8 * (q % kStages));
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    };
    // A share of a split tile in the workspace: float4 j of consumer
    // thread tid at (j * 256 + tid), so a warp's accesses are contiguous.
    auto slot = [&](int cta) {
      return reinterpret_cast<float4*>(ws) + static_cast<long long>(cta) * (kBM * BN / 4) + tid;
    };
    // End of the unit (tile, k0, k1): hand a later share to the tile's first
    // CTA, or add the later shares to a first one, then the epilogue.
    auto finish = [&]() {
      if (k0 > 0) {
        // a later share of a split tile: hand its sum to the tile's first CTA
        float4* mine = slot(blockIdx.x);
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          __stcg(mine + j * 256, make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                                             acc[4 * j + 3]));
        consumers_sync();  // then thread 0's release covers every thread's stores
        flag_release(flags + blockIdx.x, 1, tid == 0);
        return;
      }
      if (k1 < p.kt) {
        // the first share of a split tile: add the later ones in K order
        const int tile_end = (tile - p.whole + 1) * p.kt;
        for (int c = blockIdx.x + 1; c < p.sk_ctas && stream_k::share_start(p, c) < tile_end;
             ++c) {
          flag_wait(flags + c);
          consumers_sync();  // every thread has seen the flag: reset it for the next launch
          flag_release(flags + c, 0, tid == 0);
          const float4* theirs = slot(c);
#pragma unroll
          for (int j = 0; j < BN / 8; ++j) {
            const float4 v = __ldcg(theirs + j * 256);
            acc[4 * j] += v.x;
            acc[4 * j + 1] += v.y;
            acc[4 * j + 2] += v.z;
            acc[4 * j + 3] += v.w;
          }
        }
      }

      // ---- epilogue: folded BN, residual, ReLU, extents mask; float2 stores ----
      const int tm = tile / p.tiles_n;
      const int m0 = tm * kBM;
      const int n0 = (tile - tm * p.tiles_n) * BN;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = m0 + ra + 8 * hr;
        if (m >= M) continue;
        bool zero = false;
        if (extents != nullptr) {
          const int b = m / HW;
          const int rem = m - b * HW;
          const int h = rem / W;
          zero = h >= extents[2 * b] || rem - h * W >= extents[2 * b + 1];
        }
        float* orow = out + static_cast<long long>(m) * N;
        const float* rrow = resid != nullptr ? resid + static_cast<long long>(m) * N : nullptr;
#pragma unroll
        for (int i = 0; i < BN / 8; ++i) {
          const int n = n0 + 8 * i + 2 * t;
          const float2 sc = *reinterpret_cast<const float2*>(sb + n);
          const float2 bi = *reinterpret_cast<const float2*>(sb + N + n);
          float2 v;
          v.x = acc[4 * i + 2 * hr] * sc.x + bi.x;
          v.y = acc[4 * i + 2 * hr + 1] * sc.y + bi.y;
          if (rrow != nullptr) {
            const float2 rv = *reinterpret_cast<const float2*>(rrow + n);
            v.x += rv.x;
            v.y += rv.y;
          }
          v.x = zero ? 0.f : fmaxf(v.x, 0.f);
          v.y = zero ? 0.f : fmaxf(v.y, 0.f);
          *reinterpret_cast<float2*>(orow + n) = v;
        }
      }
    };
    // Two register sets of fragments: the next stage's are split while
    // the current stage's products run, across unit boundaries too.  The
    // ring position q counts the CTA's stages from 0 in one flat loop, so
    // the descriptors and barriers it addresses stay on the uniform
    // datapath (carried through a loop over units, ptxas kept q in
    // vector registers and moved every wgmma descriptor with R2UR).
    uint32_t big0[4][4], small0[4][4], big1[4][4], small1[4][4];
    units.next(p, tile, k0, k1);  // every CTA of the plan has a unit
    unsigned end = k1 - k0;       // ring position after the unit's last stage
    bool more = false;            // a unit follows the current one
    int tile2 = 0, k02 = 0, k12 = 0;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    // Stage q from `cur`; split stage q + 1 into `nxt` where the CTA has
    // one; at a unit's end finish it and take the next.  False when done.
    auto step = [&](unsigned q, const uint32_t (&cur_b)[4][4], const uint32_t (&cur_s)[4][4],
                    uint32_t (&nxt_b)[4][4], uint32_t (&nxt_s)[4][4]) {
      mma(q, cur_b, cur_s);
      const bool last = q + 1 == end;
      if (last) more = units.next(p, tile2, k02, k12);
      if (!last || more) load(q + 1, nxt_b, nxt_s);
      retire(q);
      if (!last) return true;
      finish();
      if (!more) return false;
      tile = tile2;
      k0 = k02;
      k1 = k12;
      end += k1 - k0;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
      return true;
    };
    load(0, big0, small0);
    for (unsigned q = 0;; q += 2) {
      if (!step(q, big0, small0, big1, small1)) break;
      if (!step(q + 1, big1, small1, big0, small0)) break;
    }
  }
}

// D[64 x N] += A[64 x 16] * B[16 x N], both bf16 K-major in shared memory.
__device__ __forceinline__ void wgmma_bf16_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                               int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_bf16_n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// The bf16 form of conv_gemm_tf32x3 (same arguments, same tiles and ring;
// see the note at the top): out[m, n] = bf16(epilogue(sum_k A[m, k] *
// Wt[n, k])), A and Wt bf16, Wt [N, K] K-major, resid bf16 [M, N] or
// null.  K must be a multiple of 64 (one stage), Cin too with TAP3.
template <int NWG, int BN, bool TAP3>
__global__ void __launch_bounds__(128 * (NWG + 1), 1)
conv_gemm_bf16(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Wt,
               const float* __restrict__ sb, const __nv_bfloat16* __restrict__ resid,
               const int* __restrict__ extents, __nv_bfloat16* __restrict__ out, int M, int K,
               int N, int H, int W, int Cin) {
  constexpr int BK = 64;  // K depth of one stage: 128 bytes of bf16
  constexpr int BM = 64 * NWG;
  constexpr int A_BYTES = BM * 128;
  constexpr int B_BYTES = BN * 128;
  constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sbase = (raw + 1023u) & ~1023u;  // swizzle atoms need 1024-byte alignment
  const uint32_t full0 = sbase + kStages * STAGE_BYTES;
  const uint32_t empty0 = full0 + 8 * kStages;

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 128);
      mbar_init(empty0 + 8 * s, 128 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int KT = K / BK;
  const int HW = H * W;

  if (wg == NWG) {
    // ---- producer warpgroup: 16-byte chunk `chunk` (8 values) of rows row0 + 16 i ----
    const int pt = tid - 128 * NWG;
    const int chunk = pt & 7;
    const int row0 = pt >> 3;
    constexpr int AR = BM / 16;
    constexpr int BR = BN / 16;
    const __nv_bfloat16* a_row = A + static_cast<long long>(m0 + row0) * Cin + chunk * 8;
    const __nv_bfloat16* w_row = Wt + static_cast<long long>(n0 + row0) * K + chunk * 8;
    int ahw[AR];
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int rem = (m0 + row0 + 16 * i) % HW;
      ahw[i] = ((rem / W) << 16) | (rem % W);
    }
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(empty0 + 8 * s, ((kt / kStages) & 1) ^ 1);
      const int k0 = kt * BK;
      const uint32_t sa = sbase + s * STAGE_BYTES;
      int dy = 1, dx = 1, ci = k0;
      if (TAP3) {
        const int tap = k0 / Cin;
        ci = k0 - tap * Cin;
        dy = tap / 3;
        dx = tap - 3 * dy;
      }
      const int tap_off = ((dy - 1) * W + (dx - 1)) * Cin + ci;
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const int r = row0 + 16 * i;
        bool ok = m0 + r < M;
        if (TAP3) {
          const int hh = (ahw[i] >> 16) + dy - 1;
          const int ww = (ahw[i] & 0xffff) + dx - 1;
          ok = ok && hh >= 0 && hh < H && ww >= 0 && ww < W;
        }
        const __nv_bfloat16* src = ok ? a_row + (16 * i * Cin + tap_off) : A;
        cp_async16(sa + r * 128 + ((chunk ^ (r & 7)) << 4), src, ok);
      }
      const uint32_t sb_w = sa + A_BYTES;
#pragma unroll
      for (int i = 0; i < BR; ++i) {
        const int r = row0 + 16 * i;
        cp_async16(sb_w + r * 128 + ((chunk ^ (r & 7)) << 4), w_row + (16 * i * K + k0), true);
      }
      cp_async_mbar_arrive(full0 + 8 * s);
    }
  } else {
    // ---- consumer warpgroup wg: output rows wg * 64 .. + 63 of the tile ----
    const int lane = tid & 31;
    const int warp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int t = lane & 3;
    const int ra = wg * 64 + warp * 16 + g;  // this thread's output rows: ra, ra + 8
    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
    fence_regs(acc);
    for (int kt = 0; kt < KT; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full0 + 8 * s, (kt / kStages) & 1);
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      const uint32_t sa = sbase + s * STAGE_BYTES + wg * 64 * 128;
      const uint32_t sw = sbase + s * STAGE_BYTES + A_BYTES;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(sa + 32 * kk);
        const uint64_t db = desc_sw128(sw + 32 * kk);
        if constexpr (BN == 128) {
          wgmma_bf16_n128(acc, da, db, kt > 0 || kk > 0);
        } else {
          wgmma_bf16_n64(acc, da, db, kt > 0 || kk > 0);
        }
      }
      wgmma_commit();
      // the previous stage's products have retired: release its slot
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > 0) mbar_arrive(empty0 + 8 * ((kt - 1) % kStages));
    }
    wgmma_wait<0>();
    fence_regs(acc);

    // ---- epilogue: folded BN, residual, ReLU, extents mask, bf16; 4-byte stores ----
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = m0 + ra + 8 * hr;
      if (m >= M) continue;
      bool zero = false;
      if (extents != nullptr) {
        const int b = m / HW;
        const int rem = m - b * HW;
        const int h = rem / W;
        zero = h >= extents[2 * b] || rem - h * W >= extents[2 * b + 1];
      }
      __nv_bfloat16* orow = out + static_cast<long long>(m) * N;
      const __nv_bfloat16* rrow =
          resid != nullptr ? resid + static_cast<long long>(m) * N : nullptr;
#pragma unroll
      for (int i = 0; i < BN / 8; ++i) {
        const int n = n0 + 8 * i + 2 * t;
        const float2 sc = *reinterpret_cast<const float2*>(sb + n);
        const float2 bi = *reinterpret_cast<const float2*>(sb + N + n);
        float2 v;
        v.x = acc[4 * i + 2 * hr] * sc.x + bi.x;
        v.y = acc[4 * i + 2 * hr + 1] * sc.y + bi.y;
        if (rrow != nullptr) {
          const float2 rv =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rrow + n));
          v.x += rv.x;
          v.y += rv.y;
        }
        v.x = zero ? 0.f : fmaxf(v.x, 0.f);
        v.y = zero ? 0.f : fmaxf(v.y, 0.f);
        *reinterpret_cast<__nv_bfloat162*>(orow + n) = __floats2bfloat162_rn(v.x, v.y);
      }
    }
  }
}

// SMs on the card, read once.
int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 132;
  }();
  return sms;
}

template <int BN, bool TAP3>
void launch_tf32x3(const float* A, const float* Wt, const float* sb, const float* resid,
                   const int* extents, float* out, int M, int K, int N, int H, int W, int Cin,
                   float* ws, int* flags, int slots, int* report, cudaStream_t s) {
  constexpr int SMEM = smem_bytes<BN>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_gemm_tf32x3<BN, TAP3>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  (void)attr;  // a refusal shows as the launch's error
  const Plan p = stream_k::make_plan(M, N, K, BN, std::max(1, std::min(sm_count(), slots)));
  const int split = stream_k::split_tiles(p);
  report[0] = p.grid;
  report[1] = p.tiles - split;
  report[2] = split;
  if (p.grid > 0)
    conv_gemm_tf32x3<BN, TAP3><<<p.grid, 384, SMEM, s>>>(A, Wt, sb, resid, extents, out, M, K,
                                                          N, H, W, Cin, p, ws, flags);
}

template <bool TAP3>
void launch_gemm_tf32x3(const float* A, const float* Wt, const float* sb, const float* resid,
                        const int* extents, float* out, int M, int K, int N, int H, int W,
                        int Cin, float* ws, int* flags, int slots, int* report,
                        cudaStream_t s) {
  if (N % 128 == 0)
    launch_tf32x3<128, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, ws, flags,
                             slots, report, s);
  else
    launch_tf32x3<64, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, ws, flags,
                            slots, report, s);
}

// The bf16 form's launch: a grid of (64 * NWG) x BN tiles.
template <typename T, int NWG, int BN, bool TAP3>
void launch_tile(const T* A, const T* Wt, const float* sb, const T* resid,
                 const int* extents, T* out, int M, int K, int N, int H, int W, int Cin,
                 cudaStream_t s) {
  static_assert(std::is_same_v<T, __nv_bfloat16>, "the fp32 form launches launch_tf32x3");
  constexpr int BM = 64 * NWG;
  // a bf16 stage holds one weight copy
  constexpr int SMEM = kStages * (BM * 128 + BN * 128) + 2 * kStages * 8 + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_gemm_bf16<NWG, BN, TAP3>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  (void)attr;  // a refusal shows as the launch's error
  const dim3 grid((M + BM - 1) / BM, N / BN);
  conv_gemm_bf16<NWG, BN, TAP3><<<grid, 128 * (NWG + 1), SMEM, s>>>(A, Wt, sb, resid, extents,
                                                                    out, M, K, N, H, W, Cin);
}

// Waves of `tiles` blocks on the card (one block per SM: the ring takes
// most of the SM's shared memory).
int waves(long long tiles) {
  const int sms = sm_count();
  return static_cast<int>((tiles + sms - 1) / sms);
}

// The bf16 form's tile per launch: 128 rows unless 64-row tiles finish
// sooner.  A 64-row block has one consumer warpgroup and runs at ~0.6x
// the rate of a 128-row block, so it wins only where 128-row tiles leave
// a wave mostly empty.
template <typename T, bool TAP3>
void launch_gemm(const T* A, const T* Wt, const float* sb, const T* resid,
                 const int* extents, T* out, int M, int K, int N, int H, int W, int Cin,
                 cudaStream_t s) {
  const int bn = N % 128 == 0 ? 128 : 64;
  const long long cols = N / bn;
  const bool small = 0.6 * waves(((M + 63) / 64) * cols) < waves(((M + 127) / 128) * cols);
  if (bn == 128) {
    if (small)
      launch_tile<T, 1, 128, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, s);
    else
      launch_tile<T, 2, 128, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, s);
  } else {
    if (small)
      launch_tile<T, 1, 64, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, s);
    else
      launch_tile<T, 2, 64, TAP3>(A, Wt, sb, resid, extents, out, M, K, N, H, W, Cin, s);
  }
}

}  // namespace

// x: [B, H, W, C] fp32 contiguous; w1 [2, Cw, C], w2 [2, Cw, 9 * Cw] (K
// ordered (dy, dx, ci)), w3 [2, C, Cw]: each the (big, small) TF32 split
// of the K-major weight; sb1/sb2 [2, Cw], sb3 [2, C]; extents [B, 2] int32
// or null.  t1, t2: [B, H, W, Cw] fp32 scratch; out: [B, H, W, C].  C and
// Cw must be multiples of 64.  ws [slots, 128 * 128] fp32 and flags
// [slots] int32: the stream-K workspace, one slot and flag per CTA, used
// by one stream at a time; flags are 0 before the first call and each
// launch leaves them 0.  plan: 9 host ints, filled with each launch's
// (CTAs, whole tiles, split tiles).  Returns cudaGetLastError().
extern "C" int rir_fused_bottleneck(const float* x, const float* w1, const float* sb1,
                                    const float* w2, const float* sb2, const float* w3,
                                    const float* sb3, const int* extents, float* t1,
                                    float* t2, float* out, int B, int H, int W, int C,
                                    int Cw, float* ws, int* flags, int slots, int* plan,
                                    void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  launch_gemm_tf32x3<false>(x, w1, sb1, nullptr, extents, t1, M, C, Cw, H, W, C, ws, flags,
                            slots, plan, s);
  launch_gemm_tf32x3<true>(t1, w2, sb2, nullptr, nullptr, t2, M, 9 * Cw, Cw, H, W, Cw, ws,
                           flags, slots, plan + 3, s);
  launch_gemm_tf32x3<false>(t2, w3, sb3, x, nullptr, out, M, Cw, C, H, W, Cw, ws, flags,
                            slots, plan + 6, s);
  return static_cast<int>(cudaGetLastError());
}

// The bf16 form: x, t1, t2, out bf16 as above; w1 [Cw, C], w2 [Cw, 9 * Cw]
// (K ordered (dy, dx, ci)), w3 [C, Cw]: each the bf16 K-major weight;
// sb1 / sb2 / sb3 fp32 as above.  C and Cw must be multiples of 64.
// Returns cudaGetLastError().
extern "C" int rir_fused_bottleneck_bf16(const __nv_bfloat16* x, const __nv_bfloat16* w1,
                                         const float* sb1, const __nv_bfloat16* w2,
                                         const float* sb2, const __nv_bfloat16* w3,
                                         const float* sb3, const int* extents,
                                         __nv_bfloat16* t1, __nv_bfloat16* t2,
                                         __nv_bfloat16* out, int B, int H, int W, int C, int Cw,
                                         void* stream) {
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  const int M = B * H * W;
  using bf = __nv_bfloat16;
  launch_gemm<bf, false>(x, w1, sb1, nullptr, extents, t1, M, C, Cw, H, W, C, s);
  launch_gemm<bf, true>(t1, w2, sb2, nullptr, nullptr, t2, M, 9 * Cw, Cw, H, W, Cw, s);
  launch_gemm<bf, false>(t2, w3, sb3, x, nullptr, out, M, Cw, C, H, W, Cw, s);
  return static_cast<int>(cudaGetLastError());
}
