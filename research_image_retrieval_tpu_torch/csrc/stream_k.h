// The stream-K plan of the bottleneck kernel's fp32 form (bottleneck.cu):
// how one launch's (tile, K-stage) work is divided over its CTAs.  Plain
// C++ that nvcc and a host compiler both take: the host makes the plan,
// each CTA walks the units it gives, and the CPU tests check the plan's
// invariants (tests/stream_k_sim.cc).
#pragma once

#include <algorithm>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace stream_k {

constexpr int kBM = 128;      // rows of a tile: two consumer warpgroups of 64
constexpr int kBK = 32;       // K depth of one stage: 128 bytes of fp32
constexpr int kMinShare = 4;  // stages: the least share of the split tiles a CTA takes
// stages a split costs its busiest CTA beyond its share: the partials
// written and read back, the extra unit's start and epilogue (on an H100,
// 4 gave the index cell's launches 1.5% less kernel time than 8)
constexpr int kSplitCost = 4;

// Tiles are numbered row-major over (128-row block, BN-column block), t =
// tm * tiles_n + tn, so the CTAs running at once share their A rows.
struct Plan {
  int tiles_n;  // column tiles, N / BN
  int tiles;    // output tiles
  int kt;       // K stages of a tile
  int whole;    // tiles [0, whole) are taken whole, round robin over the grid
  int sk_ctas;  // CTAs [0, sk_ctas) share the K stages of tiles [whole, tiles):
  int sk_q;     // sk_q stages each, one more for the first sk_r
  int sk_r;
  int grid;     // CTAs launched
};

// First stage of CTA c's share, in the split tiles' (tile, stage) order.
__host__ __device__ __forceinline__ int share_start(const Plan& p, int c) {
  return c * p.sk_q + (c < p.sk_r ? c : p.sk_r);
}

// The plan for an M x N x K launch of 128 x bn tiles on `sms` SMs.  With
// R = T % sms tiles in the partial wave: where a whole wave exists the
// split region is the partial wave plus the last whole wave (R + sms
// tiles over sms CTAs: each CTA takes 1-2 tiles' stages, so a tile has
// 2-3 holders and its fixup reads 1-2 shares); else it is the R tiles
// over min(sms, R * kt / kMinShare) CTAs.  The split is taken only where
// its busiest CTA, charged kSplitCost stages for its fixup, still
// finishes before the whole tiles' last wave would; so tiles of fewer
// than 2 * kMinShare stages, and waves all but full, stay whole.
inline Plan make_plan(int M, int N, int K, int bn, int sms) {
  Plan p{};
  p.tiles_n = N / bn;
  p.tiles = (M + kBM - 1) / kBM * p.tiles_n;
  p.kt = K / kBK;
  const int full = p.tiles / sms, rem = p.tiles % sms;
  const int split = full > 0 ? rem + sms : rem;
  const int ctas = std::min(sms, split * p.kt / kMinShare);
  const int whole_stages = (full + (rem > 0)) * p.kt;
  const int split_stages =
      (full > 0 ? full - 1 : 0) * p.kt + (split * p.kt + ctas - 1) / std::max(ctas, 1);
  if (rem > 0 && p.kt >= 2 * kMinShare && ctas > rem &&
      split_stages + kSplitCost < whole_stages) {
    p.whole = p.tiles - split;
    p.sk_ctas = ctas;
    p.sk_q = split * p.kt / ctas;
    p.sk_r = split * p.kt % ctas;
    p.grid = full > 0 ? sms : ctas;
  } else {
    p.whole = p.tiles;
    p.grid = std::min(sms, p.tiles);
  }
  return p;
}

// Tiles whose K stages the plan spreads over more than one CTA.
inline int split_tiles(const Plan& p) {
  int n = 0, last = -1;
  for (int c = 1; c < p.sk_ctas; ++c) {
    const int b = share_start(p, c);
    if (b % p.kt != 0 && b / p.kt != last) {
      ++n;
      last = b / p.kt;
    }
  }
  return n;
}

// CTA `cta`'s units of work, in order: its share of the split tiles, cut
// at tile boundaries, then its whole tiles.  A unit is stages [k0, k1) of
// `tile`.  Only a CTA's first unit can be a later share (k0 > 0) of a
// tile, and a first share (k0 == 0, k1 < kt) is the last of its split
// units.
struct Units {
  int it, end, dp;
  __host__ __device__ __forceinline__ Units(const Plan& p, int cta)
      : it(0), end(0), dp(cta) {
    if (cta < p.sk_ctas) {
      it = share_start(p, cta);
      end = share_start(p, cta + 1);
    }
  }
  __host__ __device__ __forceinline__ bool next(const Plan& p, int& tile, int& k0, int& k1) {
    if (it < end) {
      const int j = it / p.kt;
      k0 = it - j * p.kt;
      k1 = k0 + end - it < p.kt ? k0 + end - it : p.kt;
      tile = p.whole + j;
      it += k1 - k0;
      return true;
    }
    if (dp < p.whole) {
      tile = dp;
      k0 = 0;
      k1 = p.kt;
      dp += p.grid;
      return true;
    }
    return false;
  }
};

}  // namespace stream_k
