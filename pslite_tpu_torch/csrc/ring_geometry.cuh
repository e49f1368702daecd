// Where an element of a bucket sits on the TPU ring, for ring_push_pull.cu.
// (ring_int8.cu takes the same layout as a table of regions, computed by
// int8_regions in ops/ring_collective.py.)
//
// A bucket of `padded` elements is cut into kv shards of `period` elements
// (1-D ring: one shard, period = padded).  Each shard is cut into sub-chunks
// of `sub` elements; sub-chunk c is owned by rank c of an n-rank ring, and
// its elements from `split` on travel direction 1.  The 1-D ring of
// pslite_tpu/ops/ring_collective.py is (period = padded, sub = chunk0, split =
// half the tile-padded chunk); the (dp, kv) sub-rings of
// pslite_tpu/parallel/engine.py:713-752 are (period = chunk_kv, sub = ksub,
// split = ksub / 2), one ring of n = A ranks per kv shard, with the tile
// padding at the end of each shard (so the last sub-chunks may be short or
// empty).  KV = false skips the shard division, so the 1-D ring pays no
// second 64-bit division per element.

#pragma once

struct RingGeo {
  long long period;  // elements per kv shard
  long long sub;     // elements per sub-chunk
  long long split;   // first element of direction 1 within a sub-chunk
  int n;             // ranks on each ring
};

struct RingPos {
  int chunk;  // owning rank of the element's sub-chunk
  int step;   // 1 for direction 0 (ranks c+1, c+2, ...), n-1 for 1
};

template <bool KV>
__device__ __forceinline__ RingPos ring_pos(const RingGeo& g, long long i) {
  long long b = 0;
  long long j = i;
  if (KV) {
    b = i / g.period;
    j = i - b * g.period;
  }
  const long long c = j / g.sub;
  const bool dir1 = (j - c * g.sub) >= g.split;
  RingPos p;
  p.chunk = static_cast<int>(c);
  p.step = dir1 ? g.n - 1 : 1;
  return p;
}

// The k-th rank (k = 1..n) a direction's walk adds, for sub-chunk c: c+1,
// c+2, ..., c+n (= c) in direction 0, c-1, ..., c in direction 1.
__device__ __forceinline__ int ring_rank(const RingPos& p, int k, int n) {
  return static_cast<int>((static_cast<long long>(p.chunk) +
                           static_cast<long long>(k) * p.step) % n);
}
