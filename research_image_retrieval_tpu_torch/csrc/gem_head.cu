// GeM pooling + whiten projection + L2 norm: the descriptor head.
//
// Replaces: research_image_retrieval_tpu/ops/gem_pallas.py
//           pallas_gem_whiten_l2 (the Pallas TPU kernel).
//
// Computes, per image b:
//   pooled[c] = (sum_hw clamp(x[b,hw,c], eps)^p * m[hw] / max(sum_hw m, 1))^(1/p)
//   y[d]      = sum_c pooled[c] * W[d, c] + bias[d]
//   out[b, d] = y[d] / max(||y||_2, 1e-12)
// with m the bucket mask: an extent pair [B, 2] (valid rows x cols), a
// dense [B, H, W] mask, or all ones.  p is read from device memory (a
// learnable GeM p never goes through the host).
//
// What bounds it on an H100: bytes.  At the main path's shape (B = 8,
// 32 x 32 x 2048 feature map, 2048 x 2048 fp32 weight) it reads 67 MB of
// feature map and 17 MB of weight for ~0.12 GFLOP of fp32 work: ~1.4
// FLOP per byte, far below the card's ~20 FLOP/byte fp32 ridge.  The
// least time is ~25 us at 3.35 TB/s.
//
// Design (three launches on the caller's stream; Hopper blocks run in no
// order, so sums cross launches through scratch, in a fixed order, with
// no atomics):
//   1. gem_pool_kernel: one block of 8 warps takes (32-channel tile,
//      image); 8 lanes read one pixel's 32 channels as float4s (128
//      contiguous bytes), so a warp reads 4 pixels per step, with 8 steps
//      of loads in flight.  Tiling C finely, not HW, is what fills the
//      card: at the main path's shape (B = 8, 32 x 32 x 2048) that is
//      64 x 8 = 512 blocks, all resident at once.  Only valid cells are
//      read: with extents the block walks the eh x ew region alone (the
//      bucket padding and crops cost no bytes); with a dense mask it skips
//      the load where the mask is 0.  The block finishes the mean and the
//      root, once per value, and writes pooled[B, C].  A bf16 map (the
//      layer4 output of a bf16 model) is read the same way, 8 values per
//      16-byte load (64-channel tiles), and pooled in fp32, as the TPU
//      kernel upcasts its block; it halves the pool's bytes.
//   2. project_kernel: one block per (32 output columns, channel slice,
//      8 images); the wrapper cuts C into KS slices (up to 4 of >= 512
//      channels; each a multiple of 8, so every 16-byte weight load stays
//      aligned).  Its prologue stages its images' pooled slice in shared
//      memory (8 x 512 fp32 = 16 KB at C = 2048), read once.  Slicing C
//      gives 256 blocks instead of 64 and cuts what every block re-reads
//      from L2 to a quarter.  Each warp computes four columns; each lane
//      holds 16 bytes of each weight row for 4 steps in flight (4 fp32 or
//      8 bf16; fp32 accumulation), issued before the prologue so that
//      their HBM latency overlaps it, and a shuffle reduction closes each
//      dot.  It writes the slice's dot products to ypart[KS, B, D].
//   3. l2norm_kernel: one block per image sums the KS slices in order,
//      adds the bias and normalizes.
// The mask is not lane-tiled 128 wide as on the TPU (a Mosaic layout
// constraint): extents cost 8 bytes per image.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kPoolThreads = 256;                 // 8 warps
constexpr int kPoolWarps = kPoolThreads / 32;
constexpr int kPoolLanes = 8;                     // lanes per pixel, 16 bytes each
constexpr int kPoolPixels = kPoolThreads / kPoolLanes;  // pixels per block step
constexpr int kPoolUnroll = 8;                    // pixels in flight per thread
constexpr int kProjWarps = 8;
constexpr int kProjCols = 4;                      // output columns per warp
constexpr int kProjSteps = 4;                     // 16-byte weight loads in flight per column
constexpr int kProjImages = 8;                    // images per block
constexpr int kNormThreads = 1024;

// 16 bytes of a weight row or of a map pixel as fp32.
__device__ __forceinline__ void load_w(const float* w, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(w);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_w(const __nv_bfloat16* w, float (&o)[8]) {
  const uint4 v = *reinterpret_cast<const uint4*>(w);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// clamp(x, eps)^p for v = clamp(x, eps) > 0, as exp2(p * log2(v)): its
// relative error is ~|p log2 v| * 2^-24 (under 1e-6 over the activations'
// range) at a fraction of powf's cost, whose extended-precision log set
// the pool's pace.
__device__ __forceinline__ float gem_pow(float v, float p) { return exp2f(p * log2f(v)); }

// pooled[b, c] = (sum over image b's valid cells of clamp(x, eps)^p * m
//                 / max(sum m, 1))^(1/p), one block per (channel tile, b).
// T is the map's type: each lane reads 16 bytes of a pixel (4 fp32 or 8
// bf16 channels) and pools in fp32.
template <typename T>
__global__ void __launch_bounds__(kPoolThreads)
gem_pool_kernel(const T* __restrict__ x, const int* __restrict__ extents,
                const float* __restrict__ mask, const float* __restrict__ p_ptr,
                float* __restrict__ pooled, int H, int W, int C, float eps) {
  constexpr int VEC = 16 / sizeof(T);              // channels per lane
  constexpr int CH = VEC * kPoolLanes;             // channels per block
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cg = threadIdx.x % kPoolLanes;  // channel group of VEC
  const int c = blockIdx.x * CH + cg * VEC;
  const bool cvalid = c < C;
  const int HW = H * W;
  int eh = H, ew = W;
  if (extents != nullptr) {
    eh = min(max(extents[2 * b], 0), H);
    ew = min(max(extents[2 * b + 1], 0), W);
  }
  const T* xb = x + (size_t)b * HW * C;
  const float* mb = mask != nullptr ? mask + (size_t)b * HW : nullptr;
  const int n = mb != nullptr ? HW : eh * ew;  // cells this image visits
  const float p = *p_ptr;

  float acc[VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) acc[e] = 0.f;
  float cnt = 0.f;
  const int px = threadIdx.x / kPoolLanes;  // this thread's pixel in each step
  for (int i0 = px; i0 < n; i0 += kPoolPixels * kPoolUnroll) {
    float v[kPoolUnroll][VEC];
    float m[kPoolUnroll];
#pragma unroll
    for (int u = 0; u < kPoolUnroll; ++u) {
      const int i = i0 + u * kPoolPixels;
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[u][e] = 0.f;
      m[u] = 0.f;
      if (i < n) {
        int cell = i;  // a dense mask visits every cell
        if (mb != nullptr) {
          m[u] = mb[i];
        } else {
          m[u] = 1.f;
          cell = i + (i / ew) * (W - ew);  // the i-th cell of the eh x ew region
        }
        if (cvalid && m[u] != 0.f) load_w(xb + (size_t)cell * C + c, v[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < kPoolUnroll; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] += gem_pow(fmaxf(v[u][e], eps), p) * m[u];
      cnt += m[u];
    }
  }
  // sum over the warp's pixels (lanes kPoolLanes apart share channels)
#pragma unroll
  for (int off = kPoolLanes; off < 32; off <<= 1) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
    cnt += __shfl_xor_sync(0xffffffffu, cnt, off);
  }

  __shared__ __align__(16) float red[kPoolWarps][CH];
  __shared__ float red_cnt[kPoolWarps];
  if (lane < kPoolLanes) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) red[warp][lane * VEC + e] = acc[e];
  }
  if (lane == 0) red_cnt[warp] = cnt;
  __syncthreads();
  if (threadIdx.x < CH) {
    const int cc = blockIdx.x * CH + threadIdx.x;
    float sum = 0.f, total = 0.f;
#pragma unroll
    for (int k = 0; k < kPoolWarps; ++k) {
      sum += red[k][threadIdx.x];
      total += red_cnt[k];
    }
    if (cc < C) pooled[(size_t)b * C + cc] = powf(sum / fmaxf(total, 1.f), 1.f / p);
  }
}

// Channels per projection slice when C is cut into ks: a multiple of 8
// (so every 16-byte weight load stays aligned).
__host__ __device__ __forceinline__ int slice_len(int C, int ks) {
  return ((C + ks - 1) / ks + 7) & ~7;
}

// ypart[k, b, d] = sum over channel slice k of pooled[b, c] * W[d, c].
template <typename WT>
__global__ void __launch_bounds__(kProjWarps * 32)
project_kernel(const float* __restrict__ pooled, const WT* __restrict__ w,
               float* __restrict__ ypart, int B, int C, int D, int ks) {
  constexpr int VEC = 16 / sizeof(WT);  // weight elements per 16-byte load
  extern __shared__ __align__(16) float rows[];  // [nb][c_len]
  const int len = slice_len(C, ks);
  const int k = blockIdx.y;
  const int c_begin = k * len;
  const int c_len = min(len, C - c_begin);
  const int b0 = blockIdx.z * kProjImages;
  const int nb = min(kProjImages, B - b0);

  // each warp: kProjCols output columns; each lane 16 bytes of each of
  // their weight rows per step, kProjSteps steps in flight.  The first
  // steps' weights are loaded before the prologue, which does not need
  // them, so their HBM latency overlaps it.
  const int lane = threadIdx.x & 31;
  const int d0 = (blockIdx.x * kProjWarps + (threadIdx.x >> 5)) * kProjCols;
  const bool active = d0 < D;
  const WT* wrow[kProjCols];
#pragma unroll
  for (int q = 0; q < kProjCols; ++q) wrow[q] = w + (size_t)min(d0 + q, D - 1) * C + c_begin;
  float wv[kProjSteps][kProjCols][VEC];
  auto load_steps = [&](int c0) {
#pragma unroll
    for (int u = 0; u < kProjSteps; ++u) {
      const int c = c0 + u * 32 * VEC;
#pragma unroll
      for (int q = 0; q < kProjCols; ++q) {
        if (active && c < c_len) {
          load_w(wrow[q] + c, wv[u][q]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) wv[u][q][e] = 0.f;
        }
      }
    }
  };
  load_steps(lane * VEC);

  // prologue: this block's images' pooled slice into shared memory
  const int L4 = c_len / 4;
#pragma unroll 4
  for (int q = threadIdx.x; q < nb * L4; q += kProjWarps * 32) {
    const int j = q / L4;
    reinterpret_cast<float4*>(rows)[q] = *reinterpret_cast<const float4*>(
        pooled + (size_t)(b0 + j) * C + c_begin + 4 * (q - j * L4));
  }
  __syncthreads();
  if (!active) return;

  float acc[kProjCols][kProjImages];
#pragma unroll
  for (int q = 0; q < kProjCols; ++q)
#pragma unroll
    for (int j = 0; j < kProjImages; ++j) acc[q][j] = 0.f;
  constexpr int kBatch = kProjSteps * 32 * VEC;
  for (int c0 = lane * VEC; c0 < c_len; c0 += kBatch) {
#pragma unroll
    for (int u = 0; u < kProjSteps; ++u) {
      const int c = c0 + u * 32 * VEC;
      if (c >= c_len) break;
#pragma unroll
      for (int j = 0; j < kProjImages; ++j) {
        if (j < nb) {
          const float* pj = rows + j * c_len + c;
#pragma unroll
          for (int e = 0; e < VEC; e += 4) {
            const float4 pv = *reinterpret_cast<const float4*>(pj + e);
#pragma unroll
            for (int q = 0; q < kProjCols; ++q) {
              acc[q][j] = fmaf(pv.x, wv[u][q][e], acc[q][j]);
              acc[q][j] = fmaf(pv.y, wv[u][q][e + 1], acc[q][j]);
              acc[q][j] = fmaf(pv.z, wv[u][q][e + 2], acc[q][j]);
              acc[q][j] = fmaf(pv.w, wv[u][q][e + 3], acc[q][j]);
            }
          }
        }
      }
    }
    if (c0 + kBatch < c_len) load_steps(c0 + kBatch);
  }
#pragma unroll
  for (int q = 0; q < kProjCols; ++q)
#pragma unroll
    for (int j = 0; j < kProjImages; ++j)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        acc[q][j] += __shfl_xor_sync(0xffffffffu, acc[q][j], off);
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < kProjCols; ++q) {
      if (d0 + q < D) {
        for (int j = 0; j < nb; ++j)
          ypart[((size_t)k * B + b0 + j) * D + d0 + q] = acc[q][j];
      }
    }
  }
}

// out[b] = y / max(||y||, 1e-12) with y = sum_k ypart[k, b] + bias, the
// channel slices summed in order.
__global__ void __launch_bounds__(kNormThreads)
l2norm_kernel(const float* __restrict__ ypart, const float* __restrict__ bias,
              float* __restrict__ out, int B, int D, int ks) {
  const int b = blockIdx.x;
  float* yb = out + (size_t)b * D;
  float ss = 0.f;
  for (int d = threadIdx.x; d < D; d += kNormThreads) {
    float v = 0.f;
    for (int k = 0; k < ks; ++k) v += ypart[((size_t)k * B + b) * D + d];
    v += bias[d];
    yb[d] = v;
    ss = fmaf(v, v, ss);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float part[kNormThreads / 32];
  __shared__ float denom;
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float t = 0.f;
    for (int k = 0; k < kNormThreads / 32; ++k) t += part[k];
    denom = fmaxf(sqrtf(t), 1e-12f);
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kNormThreads) yb[d] = yb[d] / denom;
}

template <typename WT>
cudaError_t launch_project(const float* pooled, const void* w, float* ypart, int B, int C,
                           int D, int ks, cudaStream_t s) {
  const int smem = kProjImages * slice_len(C, ks) * sizeof(float);
  auto kern = project_kernel<WT>;
  static int allowed = 0;  // raised only when a call needs more
  if (smem > allowed) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    allowed = smem;
  }
  const int cols = kProjWarps * kProjCols;
  const dim3 grid((D + cols - 1) / cols, ks, (B + kProjImages - 1) / kProjImages);
  kern<<<grid, kProjWarps * 32, smem, s>>>(pooled, reinterpret_cast<const WT*>(w), ypart, B,
                                           C, D, ks);
  return cudaSuccess;
}

}  // namespace

// x: [B, H, W, C] fp32 (x_bf16 == 0) or bf16 (x_bf16 == 1) contiguous
// (C % 4 == 0; C % 8 == 0 for a bf16 map or weight).  extents: [B, 2] int32 or null; mask: [B, H, W] fp32 or null
// (at most one of the two).  p: one fp32 on the device.  w: [D, C] fp32
// (w_bf16 == 0) or bf16 (w_bf16 == 1).  ks >= 1: the projection's channel
// slices.  pooled [B, C] and ypart [ks, B, D]: fp32 scratch.  out: [B, D]
// fp32.  Returns the first CUDA error of the launches.
extern "C" int rir_gem_whiten_l2(const void* x, const int* extents, const float* mask,
                                 const float* p, const void* w, const float* bias,
                                 float* pooled, float* ypart, float* out, int w_bf16,
                                 int x_bf16, int B, int H, int W, int C, int D, int ks,
                                 float eps, void* stream) {
  if (ks < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  if (x_bf16) {
    const dim3 g1((C + 8 * kPoolLanes - 1) / (8 * kPoolLanes), B);
    gem_pool_kernel<__nv_bfloat16><<<g1, kPoolThreads, 0, s>>>(
        reinterpret_cast<const __nv_bfloat16*>(x), extents, mask, p, pooled, H, W, C, eps);
  } else {
    const dim3 g1((C + 4 * kPoolLanes - 1) / (4 * kPoolLanes), B);
    gem_pool_kernel<float><<<g1, kPoolThreads, 0, s>>>(reinterpret_cast<const float*>(x),
                                                       extents, mask, p, pooled, H, W, C, eps);
  }
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = w_bf16 ? launch_project<__nv_bfloat16>(pooled, w, ypart, B, C, D, ks, s)
             : launch_project<float>(pooled, w, ypart, B, C, D, ks, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  l2norm_kernel<<<B, kNormThreads, 0, s>>>(ypart, bias, out, B, D, ks);
  return static_cast<int>(cudaGetLastError());
}
