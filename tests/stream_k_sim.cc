// Walks the bottleneck kernel's stream-K plan (csrc/stream_k.h) on the
// host, CTA by CTA, and checks what the kernel relies on:
//   - every (tile, K stage) belongs to exactly one CTA, the grid is at
//     most the SM count, and whole tiles are never split;
//   - a CTA's share of the split tiles is at least kMinShare stages;
//   - only a CTA's first unit is a later share of a tile (one workspace
//     slot per CTA), and the first share of a tile is its CTA's last
//     split unit;
//   - the CTAs a tile's first CTA waits on, found as the kernel finds
//     them, are exactly the other holders of the tile, all with a higher
//     index;
//   - split_tiles counts the tiles held by more than one CTA.
// Usage: stream_k_sim M N K SMS [M N K SMS ...]  prints, per launch,
//   "grid tiles whole split sm_use" (sm_use: the stages done over SMS
//   times the busiest CTA's stages);
//        stream_k_sim --random SEED COUNT  checks COUNT random launches.
// Exits 1 with a message at the first broken invariant.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "stream_k.h"

using namespace stream_k;

static bool fail(const char* what, int M, int N, int K, int sms) {
  std::printf("FAIL %s at M=%d N=%d K=%d sms=%d\n", what, M, N, K, sms);
  return false;
}

static bool check(int M, int N, int K, int sms, bool print) {
  const int bn = N % 128 == 0 ? 128 : 64;
  const Plan p = make_plan(M, N, K, bn, sms);
  if (p.grid > sms || p.grid < 1) return fail("grid", M, N, K, sms);
  std::vector<int> owner(static_cast<size_t>(p.tiles) * p.kt, -1);
  int busiest = 0;
  for (int c = 0; c < p.grid; ++c) {
    Units u(p, c);
    int tile, k0, k1, n = 0, stages = 0, last_split = -1;
    while (u.next(p, tile, k0, k1)) {
      if (k0 < 0 || k0 >= k1 || k1 > p.kt || tile < 0 || tile >= p.tiles)
        return fail("unit out of range", M, N, K, sms);
      for (int k = k0; k < k1; ++k) {
        int& o = owner[static_cast<size_t>(tile) * p.kt + k];
        if (o != -1) return fail("stage held twice", M, N, K, sms);
        o = c;
      }
      if (k0 > 0 && n != 0) return fail("later share not first", M, N, K, sms);
      if (tile >= p.whole) last_split = n;
      if (k0 == 0 && k1 < p.kt && tile >= p.whole && n != last_split)
        return fail("first share not last split unit", M, N, K, sms);
      stages += k1 - k0;
      ++n;
    }
    if (c < p.sk_ctas && share_start(p, c + 1) - share_start(p, c) < kMinShare)
      return fail("share under kMinShare", M, N, K, sms);
    busiest = stages > busiest ? stages : busiest;
  }
  int split = 0;
  for (int t = 0; t < p.tiles; ++t) {
    const int first = owner[static_cast<size_t>(t) * p.kt];
    if (first < 0) return fail("stage held by none", M, N, K, sms);
    std::vector<int> others;
    for (int k = 1; k < p.kt; ++k) {
      const int o = owner[static_cast<size_t>(t) * p.kt + k];
      if (o < 0) return fail("stage held by none", M, N, K, sms);
      if (o != first && (others.empty() || others.back() != o)) others.push_back(o);
    }
    if (others.empty()) continue;
    ++split;
    if (t < p.whole) return fail("whole tile split", M, N, K, sms);
    std::vector<int> waited;  // as the kernel's fixup loop finds them
    const int tile_end = (t - p.whole + 1) * p.kt;
    for (int c = first + 1; c < p.sk_ctas && share_start(p, c) < tile_end; ++c)
      waited.push_back(c);
    if (waited != others) return fail("waits on the wrong CTAs", M, N, K, sms);
  }
  if (split != split_tiles(p)) return fail("split_tiles", M, N, K, sms);
  if (print)
    std::printf("%d %d %d %d %.4f\n", p.grid, p.tiles, p.tiles - split, split,
                static_cast<double>(p.tiles) * p.kt / (static_cast<double>(sms) * busiest));
  return true;
}

int main(int argc, char** argv) {
  if (argc == 4 && std::strcmp(argv[1], "--random") == 0) {
    std::srand(std::atoi(argv[2]));
    for (int i = 0, n = std::atoi(argv[3]); i < n; ++i) {
      const int M = 1 + std::rand() % 70000;
      const int C = 256 << (std::rand() % 4);
      const int cw = C / 4;
      const int sms = 1 + std::rand() % 160;
      if (!check(M, cw, C, sms, false) || !check(M, cw, 9 * cw, sms, false) ||
          !check(M, C, cw, sms, false))
        return 1;
    }
    std::printf("ok\n");
    return 0;
  }
  if (argc < 5 || (argc - 1) % 4 != 0) {
    std::fprintf(stderr, "usage: stream_k_sim M N K SMS [...] | --random SEED COUNT\n");
    return 2;
  }
  for (int a = 1; a < argc; a += 4)
    if (!check(std::atoi(argv[a]), std::atoi(argv[a + 1]), std::atoi(argv[a + 2]),
               std::atoi(argv[a + 3]), true))
      return 1;
  return 0;
}
