// Row kernels of the sparse tables for Hopper: sum push (scatter-add),
// row-wise Adagrad push, and pull (row gather).
//
// Replace the XLA device programs of pslite_tpu/parallel/sparse.py:
// _scatter_rows (:137), _adagrad_sparse (:179) and _pull_rows (:246).  On
// one card the all-gather of every worker's (indices, rows) is the flat
// update list in worker order, and the pull's psum_scatter of one-hot rows
// is a gather.  The table is one [S * rps, dim] allocation; global row r
// lives at flat row (r % S) * rps + r / S, and an index is taken only if
// 0 <= r and r / S < rps (out of range: the push drops it, the pull gives
// zeros).
//
// Order of arithmetic.  XLA's CPU scatter adds the updates one after
// another in list order, rounding to the table's dtype after each add, and
// row-wise Adagrad sums each row's updates over a stable jnp.argsort.  The
// push kernels add each row's updates in list order from the stored value
// (row-wise Adagrad: from zero), so a sum push equals the JAX package bit
// for bit.  Explicit _rn intrinsics keep nvcc from contracting what XLA
// keeps separate.  Row-wise Adagrad sums G*G over the row in a fixed order
// (per lane over its columns, a butterfly within each warp, then, for a
// long run, the CTAs of its cluster in turn); XLA's reduction order is not
// reproduced, so it is held to rtol 1e-5.
//
// Bound.  Bytes: the push reads the update rows and indices once and reads
// and writes each touched row once (BASELINE config 5, 8 x 4,096 updates of
// dim 64 over 7,645 rows: ~12.4 MB, 3.7 us at 3.35 TB/s).  Two latencies
// lie above that.  (1) The order: the updates must be grouped by row in
// list order, a stable sort of 32,768 keys of 21 bits, a chain of passes
// (rank, prefix, scatter), each step waiting on the one before.  (2) The
// hot row: its 6,028 updates are one dependent chain of f32 adds, 6,028 x
// 4 cycles = 12.2 us at 1.98 GHz whatever the bytes.
//
// Design: three launches per push.
// - sort_kernel (pstt_sparse_sort): one thread block cluster of C <= 16
//   CTAs of 512 threads.  CTA c takes the L = ceil(m / C) list entries from
//   c * L (kSortGrow per CTA before the cluster grows), computes each
//   entry's flat row (out of range: the sentinel S * rps, which sorts last)
//   and keeps (key, list position) in shared memory.  An LSD radix sort
//   over only bits = bit_length(S * rps) bits (21 at config 5), digits of
//   up to 11 bits: two passes at config 5, three from 2^22 rows.  Each pass
//   ranks the CTA's entries stably: warp w holds tile entries [w * 32R,
//   (w + 1) * 32R) in R rounds of 32, __match_any_sync groups equal digits
//   in a round, a popcount of the lower lanes ranks them, and a per-warp
//   histogram in shared memory carries the count from round to round; the
//   warps' histograms are then prefixed warp by warp.  The prefix across
//   the cluster is split by digit slices: every CTA sends its counts to
//   the slice owners, each owner prefixes them over the CTAs and digits and
//   sends every CTA its offsets and the slice's total, and the entries go
//   to their owner CTA (position / L).  All three exchanges are st.async
//   stores into the peer's shared memory that complete on the peer's
//   mbarrier: no fence and no cluster barrier per pass (a cluster barrier
//   with release semantics waits for every earlier store to be visible
//   across the card, a relaxed one only for the CTAs to arrive;
//   tools/sparse_micro.py times both).  After the last pass the CTA
//   writes the sorted list positions and lists its heads (where the key
//   changes); a run's length runs to
//   the next head, and the CTA's last run to the first head of the next CTA
//   that has one, which the CTAs send each other with their run counts, so
//   each places its runs in the short (<= kLong updates) and long lists in
//   the sorted order.  Capacity in shared memory: kSortCluster x kSortTile
//   = 65,536 entries; above that the same cluster loops over tiles of
//   kSortTile with the entries in device memory (two sweeps per pass:
//   counts, then ranks and scatter; a cluster barrier after each pass).
// - long_runs_kernel: one cluster per long run, CTA g on kGroup = 16 of
//   its columns (G = dim / 16 CTAs up to 16, so each SM streams 1/G of the
//   run's bytes).  Five producer warps copy each update row's 16-byte pieces
//   from where the row lies in the list (rows + pos * dim, cp.async,
//   completing on the slot's mbarrier) into a ring of kStages slots of rb
//   rows; bf16 rows stay bf16 and widen at the add, which is exact.  Rows
//   that are not 16-byte aligned, or whose bytes are not a multiple of 16,
//   are copied with plain loads and stores instead (slower, same bits).
//   One warp adds (a lane per column), software pipelined: each row's add
//   is followed by the load of the row kAhead on, from the same slot or,
//   for a slot's last rows, from the next slot after its `full` wait; the
//   ring's rows are kGroup values apart, so each load takes an immediate
//   offset.  The order of the adds is the list order, so the bits do not
//   change.  The loop's own instructions, not the bytes, bound it above
//   the 4-cycle chain (tools/sparse_micro.py times the walk alone).
// - scatter_short_kernel / adagrad_short_kernel: the short runs, launched
//   beside the long runs (programmatic dependent launch), read their rows
//   through the sorted positions directly: one thread per (run, 4 columns)
//   for the sum, one warp per run for row-wise Adagrad.  The long-run
//   kernel waits for the sort's grid (griddepcontrol.wait) before it lets
//   the short runs start.
// Each kernel writes each row back once.  No staging copy of the update
// rows is made and no library sort runs.
//
// Groups.  _sparse_group_program (sparse.py:670) runs S1/S2/S3 over the k
// tables of a push_group/pull_group as one XLA program; here a group push
// is the same three launches over every table of one dtype (a table by
// value per table, PushGroup: up to kMaxTables), and a push of one table is
// a group of one.  The hard parts, and what the design does about them:
// - Tables of very different sizes (the Criteo Kaggle layer: 3 to
//   10,131,227 rows, 8,192 updates each).  One sort over the concatenated
//   key space (~33.8 M rows, 26 bits) would hold 212,992 entries, above the
//   65,536 a cluster keeps in shared memory: its tile loop in device
//   memory, three passes.  Instead cluster q sorts table q over that
//   table's own bits, in its own entry range: one launch, every cluster at
//   once (26 clusters of 4 CTAs for Kaggle).  A cluster's size is one for
//   the launch, so the largest table sets it; a small table's cluster then
//   has CTAs past its list's end, which take no entries (nor the key
//   before their first).
// - A run list that spans tables without a host sync.  Each table keeps
//   its own run lists in its own Work (the scratch is one allocation, each
//   table at its offset); the long-run clusters and the short-run threads
//   prefix the tables' run counts from device memory at their start and
//   find their table by walking that prefix (the grid is sized from every
//   table's m, as for one table).
// - Dims that differ within a launch.  The long-run cluster is sized for
//   the launch's widest table (G = ceil(min(dim, 256) / 16) CTAs), and a
//   cluster takes G / Gt runs at once of a table whose runs need Gt CTAs
//   (a bundle: CTA g walks run g / Gt of it as rank g % Gt).  Row-wise
//   Adagrad's exchange still spans the cluster; each run sums its own Gt
//   parts in the single push's order, so every table's bits are those of
//   its own push.  Measured first with one run per cluster (the CTAs past
//   a narrower run's width idle): at the Kaggle layer beside config 5's
//   table that was 13 % slower than a chain per width class
//   (tools/sparse_rows_cmp.py --width-classes); bundles keep the three
//   launches.
// - Mixed dtypes: one chain per dtype (the ring of a long run and the
//   kernels' element type are compile-time).
// - The pull: one gather_group_kernel over every table's entries, each
//   table at its own width (16, 8, 4 or 2 bytes a thread, as its row bytes
//   and pointers allow), the table found by a binary search of the
//   launch's first item per table.
//
// The pull (gather_group_kernel) is a copy: 16-byte loads and stores where
// the row's bytes and the pointers allow, narrower otherwise; bound by its
// bytes (config 5: the 7,645 distinct rows read once, 1.96 MB, the indices,
// and 8.4 MB written: 3.1 us).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLong = 32;    // runs of more updates take the staged walk
constexpr int kStages = 3;   // ring slots of a long run's walk
constexpr int kRingBytes = 96 * 1024;  // the ring, per long-run CTA
constexpr int kTile = 256;   // columns of a long run per pass
constexpr int kRingRows = 512;  // rows of a ring slot, at most
constexpr int kLongThreads = 192;  // threads of a long-run CTA
constexpr int kGroup = 16;   // columns of a long run per CTA
constexpr int kAhead = 64;   // rows a long run's walk loads ahead
constexpr int kSortThreads = 512;  // threads of a sort CTA
constexpr int kSortWarps = 16;     // kSortThreads / 32
constexpr int kSortTile = 4096;    // list entries a sort CTA holds
constexpr int kSortCluster = 16;   // CTAs of the sort's cluster, at most
constexpr int kSortGrow = 2048;    // entries per CTA before C grows
constexpr int kDigitBits = 11;     // bits of a radix digit, at most
constexpr int kDigits = 2048;      // 1 << kDigitBits
// Dynamic shared memory of sort_kernel: the entries (key, position), the
// per-warp digit histograms (16-bit; later the heads' positions), the
// digits' offsets, the tile's digit counts, the counts a slice owner
// receives (digits x CTAs), and the running counts in device memory.
constexpr int kSortSmem = kSortTile * 8 + kSortWarps * kDigits * 2 +
                          (4 * kDigits + kSortCluster) * 4;

// x / y for x >= 0, by a shift where y is a power of two (lg = log2 y,
// else -1): the sort divides by the shard count and its tile sizes.
__device__ __forceinline__ int div_by(int x, int y, int lg) {
  return lg >= 0 ? x >> lg : x / y;
}

__device__ __forceinline__ int lg_of(int y) {
  return (y & (y - 1)) == 0 ? __ffs(y) - 1 : -1;
}

__device__ __forceinline__ int flat_row(int x, int S, int rps) {
  if (x < 0) return -1;
  const int local = x / S;  // x >= 0: truncation is floor
  if (local >= rps) return -1;
  return (x - local * S) * rps + local;
}

// Arithmetic in the table's dtype: values travel as float; a bf16 table
// rounds to bf16 after each add, as XLA's CPU backend does.
template <typename T>
struct Elem;

template <>
struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float x) { *p = x; }
  static __device__ __forceinline__ float round(float x) { return x; }
  static __device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
  }
};

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
    *p = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return round(__fadd_rn(a, b));
  }
};

// The scratch of a push, in ints (the wrapper allocates 9m + 3):
// two entry buffers of m (key, position) pairs and the heads' positions
// (m + 1) for the sort in device memory, the sorted list positions, and
// the run lists: runs[0] = short runs, runs[1] = long runs; short run
// k as (first sorted position, length, row) at runs[2 + 3k ...], long run
// k at runs[2 + 3(m - 1 - k) ...] (each list in no particular order).
struct Work {
  int2* buf0;
  int2* buf1;
  int* spos;
  int* hp;
  int* runs;
};

__host__ __device__ __forceinline__ Work work_of(int* w, int m) {
  Work k;
  k.buf0 = reinterpret_cast<int2*>(w);
  k.buf1 = k.buf0 + m;
  k.spos = w + 4 * m;
  k.hp = w + 5 * m;
  k.runs = w + 6 * m + 1;
  return k;
}

__device__ __forceinline__ int3 short_run(const int* runs, int k) {
  const int* e = runs + 2 + 3 * k;
  return make_int3(e[0], e[1], e[2]);
}
__device__ __forceinline__ int3 long_run(const int* runs, int m, int k) {
  const int* e = runs + 2 + 3 * (m - 1 - k);
  return make_int3(e[0], e[1], e[2]);
}

// One table of a push: its store and accumulator, its update rows and
// indices, its scratch (a Work of its own m, at its offset in the group's
// one allocation), its layout and how its rows may be loaded.
struct PushTable {
  void* store;
  float* acc;
  const void* rows;
  const int* idx;
  int* work;
  int m, dim, S, rps;
  int bits;  // bit_length(S * rps): the sort's key bits
  int by16;  // long runs: rows 16-byte aligned, of a multiple of 16 bytes
  int vec;   // short runs: 4 values a load
};

// The tables of one push, passed by value (a kernel parameter: no copy to
// the device precedes the launch).  A push of one table is a group of one
// (N = 1); a group push takes up to kMaxTables (8 + 48 * 72 = 3,464 bytes,
// inside the 4 KiB of kernel parameters every CUDA 12 release takes).
constexpr int kMaxTables = 48;
template <int N>
struct PushGroup {
  int count;
  PushTable t[N];
};
static_assert(sizeof(PushTable) == 72, "table layout");
static_assert(sizeof(PushGroup<kMaxTables>) + 32 <= 4096,
              "kernel parameter size");

// Table i of a group.  A group of one reads table 0 by a constant index:
// a run-time index into a one-table parameter made nvcc copy the table to
// the stack (80 bytes a thread), read back at every use.
template <int N>
__device__ __forceinline__ const PushTable& table_at(const PushGroup<N>& g,
                                                    int i) {
  return g.t[N == 1 ? 0 : i];
}

__host__ __device__ __forceinline__ const int* runs_of_table(
    const PushTable& t) {
  return t.work + 6 * t.m + 1;
}

// Long-run CTAs of a table's clusters: kGroup columns each, up to kTile.
__host__ __device__ __forceinline__ int long_ctas(int dim) {
  return ((dim < kTile ? dim : kTile) + kGroup - 1) / kGroup;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned r;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(r));
  return r;
}

// -- barriers and copies between CTAs ------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}


// Arrive on `bar` and expect `bytes` more of asynchronous completion.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Waits for data that peer CTAs sent with st.async (acquire at cluster
// scope).
__device__ __forceinline__ void mbar_wait_peers(unsigned long long* bar,
                                                unsigned parity) {
  asm volatile(
      "{\n.reg .pred P1;\nWAIT:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 P1, [%0], "
      "%1;\n@P1 bra.uni DONE;\nbra.uni WAIT;\nDONE:\n}" ::"r"(
          smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// The shared::cluster address of `p` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned peer(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_addr(p)), "r"(rank));
  return a;
}

// Stores into a peer's shared memory that complete on the peer's mbarrier
// (`bar`, a peer address too): no fence and no cluster barrier.
__device__ __forceinline__ void send(unsigned dst, int v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.s32 [%0], %1, "
      "[%2];" ::"r"(dst),
      "r"(v), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send2(unsigned dst, int a, int b,
                                      unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.s32 [%0], "
      "{%1, %2}, [%3];" ::"r"(dst),
      "r"(a), "r"(b), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void send4(unsigned dst, int4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(dst),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}

// A cluster barrier with no memory ordering: only that every CTA got here.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// -- the sort: one cluster ---------------------------------------------------------

// Sum of v over the CTA, and each thread's exclusive prefix (thread order).
__device__ __forceinline__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(kFull, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int pre = 0, tot = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int x = s_warp[w];
    pre += w < warp ? x : 0;
    tot += x;
  }
  __syncthreads();  // s_warp is free again
  *total = tot;
  return pre + incl - v;
}

// block_scan of two values at once.
__device__ __forceinline__ int2 block_scan2(int2 v, int* s_warp,
                                            int2* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int2 incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int tx = __shfl_up_sync(kFull, incl.x, o);
    const int ty = __shfl_up_sync(kFull, incl.y, o);
    if (lane >= o) {
      incl.x += tx;
      incl.y += ty;
    }
  }
  if (lane == 31) {
    s_warp[2 * warp] = incl.x;
    s_warp[2 * warp + 1] = incl.y;
  }
  __syncthreads();
  int2 pre = make_int2(0, 0), tot = make_int2(0, 0);
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    const int x = s_warp[2 * w], y = s_warp[2 * w + 1];
    if (w < warp) {
      pre.x += x;
      pre.y += y;
    }
    tot.x += x;
    tot.y += y;
  }
  __syncthreads();  // s_warp is free again
  *total = tot;
  return make_int2(pre.x + incl.x - v.x, pre.y + incl.y - v.y);
}

// The sort's shared memory beyond the entries and histograms.
struct SortShared {
  unsigned long long bar_cnt, bar_base, bar_ent, bar_runs;
  int tots[kSortCluster];      // each slice's total, from its owner
  int off[kSortCluster];       // where each slice starts
  int4 runs_of[kSortCluster];  // each CTA's (first head, last run's head,
                               // short runs, long runs) but its last run
  int warp[2 * kSortWarps];
  int prev;  // the key before this CTA's first entry
};

// One table's sort by the CTAs of one cluster.  A CTA may hold no entries
// (a small table in a group whose cluster size a larger one set).
__device__ __forceinline__ void sort_table(const int* __restrict__ idx,
                                           int* __restrict__ work, int m,
                                           int S, int rps, int bits) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int c = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lt = lanemask_lt();
  extern __shared__ __align__(16) unsigned char sort_smem[];
  int2* ent = reinterpret_cast<int2*>(sort_smem);
  unsigned short* whist = reinterpret_cast<unsigned short*>(ent + kSortTile);
  int* base = reinterpret_cast<int*>(whist + kSortWarps * kDigits);
  int* run = base + kDigits;
  int* pair = run + kDigits;  // kDigits + kSortCluster
  __shared__ SortShared sh;

  const int nrows = S * rps;
  const Work wk = work_of(work, m);
  const int L = (m + C - 1) / C;
  const int lo = c * L;
  const int n = max(0, min(L, m - lo));
  const bool big = L > kSortTile;  // entries in device memory
  const int lgS = lg_of(S), lgL = lg_of(L);
  // Rounds per warp of a tile (warp w holds tile entries [w*32R, (w+1)*32R)).
  const int R = big ? kSortTile / kSortThreads
                    : (n + kSortThreads - 1) / kSortThreads;
  const int passes = (bits + kDigitBits - 1) / kDigitBits;
  int key[8], pos[8], lr[8];
  // The first pass's entries of a tile: the raw indices, their loads in
  // flight early (rank_tile turns them into flat rows).
  auto load_indices = [&](int t0, int tn) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= R) break;
      const int i = (warp * R + r) * 32 + lane;
      key[r] = i < tn ? idx[t0 + i] : -1;  // the flat row comes later
      pos[r] = t0 + i;
    }
  };
  if (!big) load_indices(lo, n);
  if (tid == 0) {
    mbar_init(&sh.bar_cnt, 1);
    mbar_init(&sh.bar_base, 1);
    mbar_init(&sh.bar_ent, 1);
    mbar_init(&sh.bar_runs, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // Every CTA's barriers are ready before any peer sends.
  cluster_arrive_relaxed();

  // Ranks the tile [t0, t0 + tn) of the list in pass p (from the indices
  // in pass 0, else from `src`, or the CTA's entries): key/pos/lr of each
  // round, every warp's histogram, exclusive over the warps, in whist, and
  // the tile's count of each digit in run.
  auto rank_tile = [&](int p, int t0, int tn, const int2* src, int shift,
                       int nd) {
    if (p == 0 && big) load_indices(t0, tn);
    if (p > 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // every round's entry, loads in flight
        if (r >= R) break;
        const int i = (warp * R + r) * 32 + lane;
        int2 e = make_int2(-1, 0);
        if (i < tn) e = big ? __ldcg(src + t0 + i) : ent[i];
        key[r] = e.x;
        pos[r] = e.y;
      }
    }
    // Zero each warp's first nd counts (at least 8) meanwhile.
    const int q8 = max(nd, 8) >> 3, lq = __ffs(q8) - 1;
    for (int k = tid; k < kSortWarps * q8; k += kSortThreads)
      reinterpret_cast<uint4*>(whist + (k >> lq) * kDigits)[k & (q8 - 1)] =
          make_uint4(0, 0, 0, 0);
    if (p == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (r >= R) break;
        if ((warp * R + r) * 32 + lane < tn) {
          const int x = key[r], local = div_by(x, S, lgS);
          key[r] = x < 0 || local >= rps ? nrows
                                         : (x - local * S) * rps + local;
        }
      }
    }
    __syncthreads();
    unsigned short* wh = whist + warp * kDigits;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      if (r >= R) break;
      const bool ok = (warp * R + r) * 32 + lane < tn;
      const int d = ok ? (key[r] >> shift) & (nd - 1) : -1;
      if (!ok) key[r] = -1;
      const unsigned peers = __match_any_sync(kFull, d);
      const int before = ok ? wh[d] : 0;
      lr[r] = before + __popc(peers & lt);
      __syncwarp();
      if (ok && (peers & lt) == 0)
        wh[d] = static_cast<unsigned short>(before + __popc(peers));
      __syncwarp();
    }
    __syncthreads();
    // Warp by warp: each warp's count becomes the count of the warps
    // before it; two digits at a time (16-bit halves that cannot carry: a
    // tile holds at most kSortTile entries).
    for (int d2 = tid; 2 * d2 < nd; d2 += kSortThreads) {
      unsigned v[kSortWarps];
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w)
        v[w] = reinterpret_cast<const unsigned*>(whist + w * kDigits)[d2];
      unsigned sum = 0;
#pragma unroll
      for (int w = 0; w < kSortWarps; ++w) {
        reinterpret_cast<unsigned*>(whist + w * kDigits)[d2] = sum;
        sum += v[w];
      }
      run[2 * d2] = static_cast<int>(sum & 0xffffu);
      run[2 * d2 + 1] = static_cast<int>(sum >> 16);
    }
    __syncthreads();
  };

  // The cluster's prefix of the digit counts (run[] of every CTA), by
  // digit slices: CTA k owns digits [k * slice, (k + 1) * slice).  Each
  // CTA sends its counts to the owners (pair[c][dl] there); each owner
  // prefixes them over the CTAs and the digits and sends every CTA its
  // offsets (base[]) and the slice's total; then base[d] holds where
  // digit d of this CTA starts (+ the running count in device memory).
  auto cluster_offsets = [&](int nd, int phase) {
    const int slice = (nd + C - 1) / C;
    const int d0 = c * slice;
    const int ns = max(0, min(slice, nd - d0));
    // Four digits a store where the slices allow (16-byte aligned).
    const bool by4 = slice % 4 == 0;
    for (int d = tid * (by4 ? 4 : 1); d < nd;
         d += kSortThreads * (by4 ? 4 : 1)) {
      const int k = d / slice, dl = d - k * slice;
      const int nk = min(slice, nd - k * slice);
      const unsigned to = peer(pair + c * nk + dl, k);
      if (by4)
        send4(to, *reinterpret_cast<const int4*>(run + d),
              peer(&sh.bar_cnt, k));
      else
        send(to, run[d], peer(&sh.bar_cnt, k));
    }
    mbar_wait_peers(&sh.bar_cnt, phase);
    const int qd = (ns + kSortThreads - 1) / kSortThreads;  // <= 4
    const int e0 = min(tid * qd, ns), e1 = min(e0 + qd, ns);
    int tot[4], sum = 0;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // each digit's prefix over the CTAs
      tot[j] = 0;
      if (e0 + j >= e1) continue;
      int u[kSortCluster];
#pragma unroll
      for (int k = 0; k < kSortCluster; ++k)
        u[k] = k < C ? pair[k * ns + e0 + j] : 0;
#pragma unroll
      for (int k = 0; k < kSortCluster; ++k) {
        if (k < C) pair[k * ns + e0 + j] = tot[j];
        tot[j] += u[k];
      }
      sum += tot[j];
    }
    int total;
    int x = block_scan(sum, sh.warp, &total);
    int* dstart = run;  // each digit's start (the counts are sent)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (e0 + j >= e1) continue;
      dstart[e0 + j] = x;
      x += tot[j];
    }
    __syncthreads();
    for (int q = tid * (by4 ? 4 : 1); q < ns * C;
         q += kSortThreads * (by4 ? 4 : 1)) {
      const int k = q / ns, dl = q - k * ns;
      const unsigned to = peer(base + d0 + dl, k);
      if (by4) {
        const int4 u = *reinterpret_cast<const int4*>(pair + q);
        const int4 v = *reinterpret_cast<const int4*>(dstart + dl);
        send4(to, make_int4(u.x + v.x, u.y + v.y, u.z + v.z, u.w + v.w),
              peer(&sh.bar_base, k));
      } else {
        send(to, pair[q] + dstart[dl], peer(&sh.bar_base, k));
      }
    }
    if (tid < C) send(peer(&sh.tots[c], tid), total, peer(&sh.bar_base, tid));
    mbar_wait_peers(&sh.bar_base, phase);
    if (warp == 0) {
      const int v = lane < C ? sh.tots[lane] : 0;
      int incl = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += t;
      }
      if (lane < C) sh.off[lane] = incl - v;
    }
    __syncthreads();
    const int lgs = lg_of(slice);
    for (int d = tid; d < nd; d += kSortThreads)
      base[d] += sh.off[div_by(d, slice, lgs)];
    __syncthreads();
  };

  // Expected bytes of each pass's exchanges, announced on the CTA's own
  // barriers before any peer can send them.
  auto expect = [&](int nd, bool last) {
    if (tid != 0) return;
    const int slice = (nd + C - 1) / C;
    const int ns = max(0, min(slice, nd - c * slice));
    mbar_expect(&sh.bar_cnt, C * ns * 4);
    mbar_expect(&sh.bar_base, (nd + C) * 4);
    // The key before the CTA's first entry comes from the entry at lo - 1,
    // where there is one (a CTA past the list's end gets none).
    if (!big)
      mbar_expect(&sh.bar_ent, n * 8 + (last && c > 0 && lo <= m ? 4 : 0));
  };

  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    const int nd = 1 << min(kDigitBits, bits - shift);
    const int2* src = (p & 1) ? wk.buf0 : wk.buf1;  // pass p - 1's output
    int2* dst = (p & 1) ? wk.buf1 : wk.buf0;
    const bool last = p + 1 == passes;
    expect(nd, last);
    if (!big) {
      rank_tile(p, lo, n, src, shift, nd);
      if (p == 0) cluster_wait();  // every peer's barriers are ready
      cluster_offsets(nd, p & 1);
#pragma unroll
      for (int r = 0; r < 8; ++r) {  // into the owner's shared memory
        if (r >= R) break;
        if (key[r] < 0) continue;
        const int d = (key[r] >> shift) & (nd - 1);
        const int at = base[d] + whist[warp * kDigits + d] + lr[r];
        const int o = div_by(at, L, lgL);
        const unsigned bar = peer(&sh.bar_ent, o);
        send2(peer(ent + (at - o * L), o), key[r], pos[r], bar);
        // The last entry of CTA o - 1 is the key before CTA o's first.
        if (last && at == o * L - 1 + L && o + 1 < C)
          send(peer(&sh.prev, o + 1), key[r], peer(&sh.bar_ent, o + 1));
      }
      mbar_wait_peers(&sh.bar_ent, p & 1);
      continue;
    }
    // Entries in device memory: counts over every tile, the prefix, then
    // each tile ranked again and scattered, the running count carried.
    int* cnt = pair + kDigits + kSortCluster;  // kDigits: running counts
    for (int d = tid; d < nd; d += kSortThreads) cnt[d] = 0;
    for (int t0 = lo; t0 < lo + n; t0 += kSortTile) {
      rank_tile(p, t0, min(kSortTile, lo + n - t0), src, shift, nd);
      for (int d = tid; d < nd; d += kSortThreads) cnt[d] += run[d];
    }
    for (int d = tid; d < nd; d += kSortThreads) run[d] = cnt[d];
    __syncthreads();
    if (p == 0) cluster_wait();
    cluster_offsets(nd, p & 1);
    for (int d = tid; d < nd; d += kSortThreads) cnt[d] = 0;  // running
    for (int t0 = lo; t0 < lo + n; t0 += kSortTile) {
      rank_tile(p, t0, min(kSortTile, lo + n - t0), src, shift, nd);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        if (key[r] < 0) continue;
        const int d = (key[r] >> shift) & (nd - 1);
        dst[base[d] + cnt[d] + whist[warp * kDigits + d] + lr[r]] =
            make_int2(key[r], pos[r]);
      }
      __syncthreads();
      for (int d = tid; d < nd; d += kSortThreads) cnt[d] += run[d];
    }
    __threadfence();
    cluster.sync();  // the pass's entries are in device memory
  }

  // The runs.  Sorted entries: the CTA's shared memory, or device memory.
  // Heads (where the key changes) are listed in order, their positions in
  // lhp; a run's length runs to the next head, the CTA's last one to the
  // first head of the next CTA that has one (or m).
  const int2* sorted = ((passes - 1) & 1) ? wk.buf1 : wk.buf0;
  auto key_at = [&](int i) {
    return big ? __ldcg(sorted + lo + i).x : ent[i].x;
  };
  int* lhp = big ? wk.hp + lo : reinterpret_cast<int*>(whist);
  const int prev0 = c == 0 || n == 0 ? -1
                    : big            ? __ldcg(sorted + lo - 1).x
                                     : sh.prev;
  if (tid == 0) mbar_expect(&sh.bar_runs, C * 16);
  // Warp w takes the CTA's entries [w * q, (w + 1) * q) in rounds of 32
  // (coalesced): writes their positions and flags the heads; the warps'
  // head counts are prefixed, then each warp lists its heads in order.
  const int q = ((n + kSortWarps - 1) / kSortWarps + 31) & ~31;
  const int w0 = min(warp * q, n), w1 = min(w0 + q, n);
  int mine = 0;
  for (int i0 = w0; i0 < w1; i0 += 32) {
    const int i = i0 + lane;
    int k = -1;
    if (i < w1) {
      const int2 e = big ? __ldcg(sorted + lo + i) : ent[i];
      wk.spos[lo + i] = e.y;
      k = e.x;
    }
    const int up = __shfl_up_sync(kFull, k, 1);
    const int prev = lane ? up : (i ? key_at(i - 1) : prev0);
    mine += __popc(__ballot_sync(kFull, i < w1 && k != prev));
  }
  if (lane == 0) sh.warp[warp] = mine;
  __syncthreads();
  int at = 0, nloc = 0;
#pragma unroll
  for (int w = 0; w < kSortWarps; ++w) {
    at += w < warp ? sh.warp[w] : 0;
    nloc += sh.warp[w];
  }
  for (int i0 = w0; i0 < w1; i0 += 32) {
    const int i = i0 + lane;
    const int k = i < w1 ? key_at(i) : -1;
    const int up = __shfl_up_sync(kFull, k, 1);
    const int prev = lane ? up : (i ? key_at(i - 1) : prev0);
    const unsigned heads = __ballot_sync(kFull, i < w1 && k != prev);
    if (heads >> lane & 1) lhp[at + __popc(heads & lt)] = lo + i;
    at += __popc(heads);
  }
  __syncthreads();
  // Each thread takes consecutive heads and counts its short and long runs
  // (the CTA's last one aside: its length depends on the next CTAs).
  const int qh = (nloc + kSortThreads - 1) / kSortThreads;
  const int h0 = min(tid * qh, nloc), h1 = min(h0 + qh, nloc);
  int ns = 0, nl = 0;
  for (int h = h0; h < h1 && h + 1 < nloc; ++h) {
    if (key_at(lhp[h] - lo) >= nrows) continue;  // dropped updates
    if (lhp[h + 1] - lhp[h] > kLong) ++nl; else ++ns;
  }
  int2 tot;
  const int2 at0 = block_scan2(make_int2(ns, nl), sh.warp, &tot);
  const int tot_s = tot.x, tot_l = tot.y;
  // Every CTA tells every CTA its (first head, last run's head or -1,
  // short runs, long runs); each then places its runs in the two lists.
  if (tid < C) {
    const int lastv = nloc && key_at(lhp[nloc - 1] - lo) < nrows
                          ? lhp[nloc - 1] : -1;
    send4(peer(&sh.runs_of[c], tid),
          make_int4(nloc ? lhp[0] : m, lastv, tot_s, tot_l),
          peer(&sh.bar_runs, tid));
  }
  mbar_wait_peers(&sh.bar_runs, 0);
  cluster_arrive_relaxed();  // done with the peers
  int at_s = at0.x, at_l = at0.y, next = m, next_c = m;
  int short_all = 0, long_all = 0;
  for (int k = C - 1; k >= 0; --k) {  // each CTA's runs, its last included
    const int4 r = sh.runs_of[k];
    int ks = r.z, kl = r.w;
    if (r.y >= 0) {
      if (next - r.y > kLong) ++kl; else ++ks;
    }
    if (k < c) {
      at_s += ks;
      at_l += kl;
    }
    if (k == c) next_c = next;
    short_all += ks;
    long_all += kl;
    if (r.x < m) next = r.x;
  }
  if (c == 0 && tid == 0) {
    wk.runs[0] = short_all;
    wk.runs[1] = long_all;
  }
  for (int h = h0; h < h1; ++h) {
    const int g = lhp[h], k = key_at(g - lo);
    if (k >= nrows) continue;
    const int len = (h + 1 < nloc ? lhp[h + 1] : next_c) - g;
    int* e = wk.runs + 2 + 3 * (len > kLong ? m - 1 - at_l++ : at_s++);
    e[0] = g;
    e[1] = len;
    e[2] = k;
  }
  cluster_wait();
}

// The sorts of a push: cluster q of the grid sorts table q.  The cluster
// size is one for the launch, set by its largest table (sort_cluster).
template <int N>
__global__ void __launch_bounds__(kSortThreads, 1)
sort_kernel(const PushGroup<N> grp) {
  // The long runs' kernel may start: it waits for this grid before it
  // reads anything.
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const PushTable& t =
      table_at(grp, blockIdx.x / cg::this_cluster().num_blocks());
  sort_table(t.idx, t.work, t.m, t.S, t.rps, t.bits);
}

// -- long runs: one cluster each ------------------------------------------------

// One 16-byte asynchronous copy into shared memory (cp.async, no
// registers held); the compiler may move plain loads across it.
__device__ __forceinline__ void copy16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}

// Arrive on `bar` once this thread's earlier cp.async copies have landed
// (counted as one of the barrier's expected arrivals).
__device__ __forceinline__ void copy16_arrive(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One column's walk through a run's `len` rows, staged in the ring rb rows
// per slot (rb a multiple of kAhead), rows 2^LG bytes apart (a constant:
// each load takes an immediate offset, no address arithmetic per row): x
// plus every row, in order.
// Software pipelined: each row's add is followed by the load of the row
// kAhead on, from this slot or, for a slot's last kAhead rows, from the
// next one after its `full` wait; rows past a slot's last are loaded too
// (the ring is padded by kAhead rows) but never added.  `it` counts the
// CTA's stages; each warp's lane 0 releases a slot after the warp's last
// adds from it.  PROBE: `waited` gathers the SM cycles spent waiting on
// `full`.
template <typename T, bool PROBE, int LG>
__device__ __forceinline__ float walk(float x, const T* ring, int col, int rb,
                                      int len, unsigned& it,
                                      unsigned long long* full,
                                      unsigned long long* empty, int lane,
                                      long long& waited) {
  constexpr int ldt = (1 << LG) / static_cast<int>(sizeof(T));
  const int nb = (len + rb - 1) / rb;
  unsigned s = it % kStages;
  long long t = PROBE ? clock64() : 0;
  mbar_wait(&full[s], (it / kStages) & 1);
  if (PROBE) waited += clock64() - t;
  const T* slot = ring + s * rb * ldt + col;
  int cnt = min(rb, len);
  float v[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) v[i] = Elem<T>::load(slot + i * ldt);
  for (int b = 0; b < nb; ++b) {
    // The slot's groups of kAhead rows but its last: the rows kAhead on lie
    // in this slot.
    int r0 = 0;
    for (; r0 + kAhead < cnt; r0 += kAhead) {
      const T* ahead = slot + (r0 + kAhead) * ldt;
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        x = Elem<T>::add(x, v[i]);
        v[i] = Elem<T>::load(ahead + i * ldt);
      }
    }
    // Its last group: a full slot's hands over to the next slot's first rows.
    unsigned s1 = s;
    const T* slot1 = slot;
    int cnt1 = 0;
    if (b + 1 < nb) {
      s1 = (it + 1) % kStages;
      if (PROBE) t = clock64();
      mbar_wait(&full[s1], ((it + 1) / kStages) & 1);
      if (PROBE) waited += clock64() - t;
      slot1 = ring + s1 * rb * ldt + col;
      cnt1 = min(rb, len - (b + 1) * rb);
#pragma unroll
      for (int i = 0; i < kAhead; ++i) {
        x = Elem<T>::add(x, v[i]);
        v[i] = Elem<T>::load(slot1 + i * ldt);
      }
    } else {  // the run's last rows
#pragma unroll
      for (int i = 0; i < kAhead; ++i)
        if (i < cnt - r0) x = Elem<T>::add(x, v[i]);
    }
    __syncwarp();  // every lane has added its last row from the slot
    if (lane == 0) mbar_arrive(&empty[s]);
    ++it;
    s = s1;
    slot = slot1;
    cnt = cnt1;
  }
  return x;
}

// Row-wise Adagrad of a long run, by one CTA's adding warp: the row's sum
// of squares in a fixed order (the warp's butterfly, then the CTAs of the
// cluster in turn, their sums sent to every CTA into `part`, completing
// on `bar`), then the step of the CTA's columns; the run's first CTA
// writes acc[row].  Every one of the cluster's G CTAs (rank g) sends; the
// sum takes the Gt parts from `first`, the run's CTAs in the single push's
// order (a group's cluster is as wide as its widest table, and takes
// G / Gt runs of a narrower one at once); rank gt among them picks the
// columns.  A CTA without a run (`live` false) sends zero and stops.
template <typename T>
__device__ __forceinline__ void adagrad_step(
    T* store, float* acc, int row, int dim, int g, int G, int first, int Gt,
    int gt, bool live, float sq, float acc0, float lr, float eps,
    const float* s_g, float* part, unsigned long long* bar,
    unsigned parity) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
  if (lane < G)
    send(peer(part + g, lane), __float_as_int(sq), peer(bar, lane));
  mbar_wait_peers(bar, parity);
  if (!live) return;
  float total = part[first];
  for (int w = 1; w < Gt; ++w) total = __fadd_rn(total, part[first + w]);
  const float a = __fadd_rn(acc0, __fdiv_rn(total, static_cast<float>(dim)));
  const float denom = __fadd_rn(__fsqrt_rn(a), eps);
  for (int c0 = 0; c0 < dim; c0 += kTile) {
    const int c = c0 + kGroup * gt + lane;
    if (lane >= min(kGroup, min(kTile, dim - c0) - kGroup * gt)) continue;
    const float stp = Elem<T>::round(__fdiv_rn(__fmul_rn(lr, s_g[c]), denom));
    T* dst = store + static_cast<long long>(row) * dim + c;
    Elem<T>::store(dst, __fsub_rn(Elem<T>::load(dst), stp));
  }
  if (gt == 0 && lane == 0) acc[row] = a;
}

// The long runs: one cluster per run, CTA g of it on the kGroup columns
// from kGroup * g of each tile of up to kTile columns (kTile / kGroup CTAs
// at most), so each SM streams a fraction of the run's bytes.  In each CTA
// warp 0 adds (one lane per column) and the other warps produce: each
// stage, rb rows of the group's columns are copied from their list
// positions into ring slot it % kStages, 16 bytes per thread and cp.async
// (`by16`: rows 16-byte aligned, of a multiple of 16 bytes), else plain
// loads and stores; `full[slot]` completes on every producer thread's
// arrival after its copies; the adding warp releases the slot on
// `empty[slot]`.  Each producer thread loads the list positions of its
// rows one stage ahead.  `it` counts stages over every tile and run the
// CTA takes, so producers and the adding warp agree on slots and phases.
// Row-wise Adagrad: each CTA's sum of squares over its columns (per lane
// over the tiles, then a butterfly in the warp) goes to every CTA of the
// cluster (st.async, two buffers by run parity), and each adds them in CTA
// order.  Dynamic shared memory: the ring (kStages * rb + kAhead rows of
// kGroup values), then for row-wise Adagrad the run's G (dim floats).
// PROBE: for each run's first tile, CTA 0's lane 0 records the SM cycles
// of its walk and of its waits on `full`, its producer thread 0 those of
// its waits on `empty` (probe[4h ...] = length, walk, adder wait, producer
// wait); the push's own instantiations read no clock.
template <typename T, bool ADAGRAD, bool PROBE, int N>
__global__ void __launch_bounds__(kLongThreads, 2)
long_runs_kernel(const PushGroup<N> grp, int rb, float lr, float eps,
                 long long* __restrict__ probe) {
  // Ring rows of kGroup values, 2^kLg bytes.
  constexpr int kLg = (sizeof(T) == 4 ? 2 : 1) + (kGroup == 32 ? 5 : 4);
  constexpr int ldt = kGroup;
  extern __shared__ __align__(128) unsigned char long_smem[];
  __shared__ __align__(8) unsigned long long full[kStages], empty[kStages];
  __shared__ __align__(8) unsigned long long bar_sq[2];
  __shared__ float s_part[2][kTile / kGroup];
  __shared__ int s_first[N + 1];  // the group's bundles before table i
  __shared__ int s_runs[N];       // each table's long runs
  cg::cluster_group cluster = cg::this_cluster();
  const int G = static_cast<int>(cluster.num_blocks());
  const int g = static_cast<int>(cluster.block_rank());
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pt = threadIdx.x - 32;  // producer thread
  constexpr int np = kLongThreads - 32;  // producer threads
  T* ring = reinterpret_cast<T*>(long_smem);
  float* s_g = reinterpret_cast<float*>(
      long_smem + (static_cast<size_t>(kStages * rb + kAhead) << kLg));
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], np);
      mbar_init(&empty[s], 1);
    }
    mbar_init(&bar_sq[0], 1);
    mbar_init(&bar_sq[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_arrive_relaxed();
  // The sort's grid first; then the short runs' kernel, launched next, may
  // start beside this one: it touches other rows, and waits for this grid
  // before it completes.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  // The group's list of bundles: a cluster takes G / Gt runs of a table
  // whose runs need Gt of its G CTAs at once (a bundle), and table i's
  // bundles follow those of the tables before it (their run counts, from
  // the sort, prefixed here: no host sync).  A push of one table walks its
  // runs one a cluster, as before groups.
  if constexpr (N > 1) {
    if (threadIdx.x < grp.count) {
      const PushTable& t = grp.t[threadIdx.x];
      const int pb = G / long_ctas(t.dim), runs = runs_of_table(t)[1];
      s_runs[threadIdx.x] = runs;
      s_first[threadIdx.x + 1] = (runs + pb - 1) / pb;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s_first[0] = 0;
      for (int i = 0; i < grp.count; ++i) s_first[i + 1] += s_first[i];
    }
    __syncthreads();
  }
  cluster_wait();  // every CTA's barriers are ready
  const int nbundles =
      N == 1 ? runs_of_table(grp.t[0])[1] : s_first[grp.count];
  const int nclusters = gridDim.x / G;
  unsigned it = 0;  // stages so far
  int j = 0;        // bundles so far
  int tb = 0;       // the table of bundle u (u only grows)
  for (int u = blockIdx.x / G; u < nbundles; u += nclusters, ++j) {
    if constexpr (N > 1)
      while (u >= s_first[tb + 1]) ++tb;
    const PushTable& tt = table_at(grp, tb);
    T* __restrict__ store = static_cast<T*>(tt.store);
    float* __restrict__ acc = tt.acc;
    const T* __restrict__ rows = static_cast<const T*>(tt.rows);
    const int m = tt.m, dim = tt.dim;
    const bool by16 = tt.by16 != 0;
    const int* __restrict__ spos = tt.work + 4 * m;
    // This CTA's run of the bundle and its rank among that run's Gt CTAs
    // (CTAs past the bundle's runs idle: they take part in the exchange).
    int Gt = G, sub = 0, gt = g, h = u;  // a push of one table: Gt == G
    bool live = true;
    if constexpr (N > 1) {
      Gt = long_ctas(dim);
      const int pb = G / Gt;
      sub = g / Gt;
      gt = g - sub * Gt;
      h = (u - s_first[tb]) * pb + sub;  // the table's long run
      live = sub < pb && h < s_runs[tb];
    }
    int start = 0, len = 0, row = 0;
    if (live) {
      const int3 lrun = long_run(runs_of_table(tt), m, h);
      start = lrun.x;
      len = lrun.y;
      row = lrun.z;
    }
    const int nb = (len + rb - 1) / rb;
    float sq = 0.f, acc0 = 0.f;
    if (ADAGRAD) {
      if (live) acc0 = acc[row];  // before any CTA can write it
      if (threadIdx.x == 0) mbar_expect(&bar_sq[j & 1], G * 4);
    }
    for (int c0 = 0; live && c0 < dim; c0 += kTile) {
      const int gc = c0 + kGroup * gt;  // the group's first column
      const int gw = min(kGroup, min(kTile, dim - c0) - kGroup * gt);
      if (gw <= 0) continue;  // this tile is narrower than the group
      if (pt >= 0 && by16) {  // the producers, 16 bytes each per row
        const int cpr = gw * static_cast<int>(sizeof(T)) / 16;  // per row
        const int per = np / cpr;  // rows per sweep of the producers
        const int rr = pt / cpr, k = pt - rr * cpr;
        const char* src0 = reinterpret_cast<const char*>(rows + gc) + 16 * k;
        int pk[8];  // the list positions of this thread's rows, a stage ahead
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = rr + i * per;
          pk[i] = r < min(rb, len) ? spos[start + r] : 0;
        }
        long long waited = 0;
        for (int b = 0; b < nb; ++b, ++it) {
          const int s = it % kStages;
          const long long t = PROBE ? clock64() : 0;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          if (PROBE) waited += clock64() - t;
          const int cnt = min(rb, len - b * rb);
          int cur[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) cur[i] = pk[i];
          if (b + 1 < nb) {
            const int next = min(rb, len - (b + 1) * rb);
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int r = rr + i * per;
              pk[i] = r < next ? spos[start + (b + 1) * rb + r] : 0;
            }
          }
          char* dst0 = reinterpret_cast<char*>(ring + s * rb * ldt) + 16 * k;
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            const int r = rr + i * per;
            if (r < cnt)
              copy16(dst0 + r * ldt * static_cast<int>(sizeof(T)),
                     src0 + static_cast<long long>(cur[i]) * dim * sizeof(T));
          }
          copy16_arrive(&full[s]);
        }
        if (PROBE && gt == 0 && pt == 0 && c0 == 0) probe[4 * h + 3] = waited;
      } else if (pt >= 0) {  // the producers, plain loads and stores
        const int pw = pt >> 5;
        constexpr int nw = np >> 5;
        for (int b = 0; b < nb; ++b, ++it) {
          const int s = it % kStages;
          if (it >= kStages) mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
          const int cnt = min(rb, len - b * rb);
          T* slot = ring + s * rb * ldt;
          for (int r = pw; r < cnt; r += nw) {
            const T* src =
                rows + static_cast<long long>(spos[start + b * rb + r]) * dim +
                gc;
            if (lane < gw) slot[r * ldt + lane] = src[lane];
          }
          mbar_arrive(&full[s]);  // release: this thread's stores
        }
      } else {  // the adding warp, lane on column gc + lane
        const bool mine = lane < gw;
        T* dst = store + static_cast<long long>(row) * dim + gc + lane;
        float x = (!ADAGRAD && mine) ? Elem<T>::load(dst) : 0.f;
        long long t0 = PROBE ? clock64() : 0, waited = 0;
        x = walk<T, PROBE, kLg>(x, ring, mine ? lane : 0, rb, len, it, full,
                                empty, lane, waited);
        if (PROBE && gt == 0 && lane == 0 && c0 == 0) {
          probe[4 * h] = len;
          probe[4 * h + 1] = clock64() - t0;
          probe[4 * h + 2] = waited;
        }
        if (mine) {
          if (ADAGRAD) {
            s_g[gc + lane] = x;
            sq = __fadd_rn(sq, __fmul_rn(x, x));
          } else {
            Elem<T>::store(dst, x);
          }
        }
      }
    }
    if constexpr (ADAGRAD) {
      if (warp == 0)
        adagrad_step(store, acc, row, dim, g, G, sub * Gt, Gt, gt, live, sq,
                     acc0, lr, eps, s_g, s_part[j & 1], &bar_sq[j & 1],
                     (j >> 1) & 1);
    }
  }
  // No CTA leaves while a peer may still send to it.
  cluster_arrive_relaxed();
  cluster_wait();
}

// -- short runs -------------------------------------------------------------------

// Four consecutive values of an update row as floats: one 16-byte (f32)
// or 8-byte (bf16) load when `vec` (rows of a multiple of 4 values from an
// aligned base), else one load each.
__device__ __forceinline__ void load4(const float* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? p[e] : 0.f;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, int n, bool vec,
                                      float (&v)[4]) {
  if (vec) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&q.x);
    const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&q.y);
    v[0] = __low2float(lo); v[1] = __high2float(lo);
    v[2] = __low2float(hi); v[3] = __high2float(hi);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < n ? __bfloat162float(p[e]) : 0.f;
}

// The items (thread-quads or warps) of a short-run launch: for a group,
// s_first[i] counts those of the tables before table i, prefixed from the
// sort's run counts in device memory (needs blockDim.x >= N); a group of
// one reads its count alone, with no barrier and no prefix (their
// registers cost a single push's Adagrad short runs resident warps).
template <int N, typename F>
__device__ __forceinline__ long long short_items(const PushGroup<N>& grp,
                                                 long long* s_first,
                                                 F items) {
  if constexpr (N == 1) {
    const PushTable& t = grp.t[0];
    return items(runs_of_table(t)[0], t.dim);
  } else {
    if (threadIdx.x < grp.count) {
      const PushTable& t = grp.t[threadIdx.x];
      s_first[threadIdx.x + 1] = items(runs_of_table(t)[0], t.dim);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      s_first[0] = 0;
      for (int i = 0; i < grp.count; ++i) s_first[i + 1] += s_first[i];
    }
    __syncthreads();
    return s_first[grp.count];
  }
}

// Item t's index in its table, whose position tb advances from the last
// item's (t only grows).
template <int N>
__device__ __forceinline__ long long item_in_table(long long t, int& tb,
                                                   const long long* s_first) {
  if constexpr (N == 1) {
    return t;
  } else {
    while (t >= s_first[tb + 1]) ++tb;
    return t - s_first[tb];
  }
}

// Sum push of the short runs: one thread per (run, 4 columns), four
// in-order chains side by side, each row read through its list position;
// the group's tables one after another.
template <typename T, int N>
__global__ void scatter_short_kernel(const PushGroup<N> grp) {
  __shared__ long long s_first[N + 1];
  const long long work = short_items(grp, s_first, [](int runs, int dim) {
    return static_cast<long long>(runs) * ((dim + 3) / 4);
  });
  int tb = 0;  // the table of item t
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       t < work; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long u = item_in_table<N>(t, tb, s_first);
    const PushTable& tt = table_at(grp, tb);
    const int dim = tt.dim, quads = (dim + 3) / 4;
    const T* __restrict__ rows = static_cast<const T*>(tt.rows);
    const int* __restrict__ spos = tt.work + 4 * tt.m;
    const int h = static_cast<int>(u / quads);
    const int c0 = static_cast<int>(u - static_cast<long long>(h) * quads) * 4;
    const int3 run = short_run(runs_of_table(tt), h);  // (start, len, row)
    const int n = min(4, dim - c0);
    T* dst = static_cast<T*>(tt.store) + static_cast<long long>(run.z) * dim +
             c0;
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = e < n ? Elem<T>::load(dst + e) : 0.f;
    for (int r = 0; r < run.y; ++r) {
      float v[4];
      load4(rows + static_cast<long long>(spos[run.x + r]) * dim + c0, n,
            tt.vec != 0, v);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (e < n) x[e] = Elem<T>::add(x[e], v[e]);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < n) Elem<T>::store(dst + e, x[e]);
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the long runs' grid
}

// Row-wise Adagrad of the short runs: one warp per run, lanes over columns
// in chunks of 32.  Pass 1 sums each column of G (from zero, in list
// order) and the squares; pass 2 sums G again, the same way, and steps the
// row.
template <typename T, int N>
__global__ void adagrad_short_kernel(const PushGroup<N> grp, float lr,
                                     float eps) {
  __shared__ long long s_first[N + 1];
  const int nruns = static_cast<int>(short_items(
      grp, s_first,
      [](int runs, int) { return static_cast<long long>(runs); }));
  const int lane = threadIdx.x & 31;
  const int step = gridDim.x * (blockDim.x >> 5);
  int tb = 0;  // the table of run h
  for (int h = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       h < nruns; h += step) {
    const int k = static_cast<int>(item_in_table<N>(h, tb, s_first));
    const PushTable& tt = table_at(grp, tb);
    const int dim = tt.dim;
    const T* __restrict__ rows = static_cast<const T*>(tt.rows);
    T* __restrict__ store = static_cast<T*>(tt.store);
    float* __restrict__ acc = tt.acc;
    const int3 run = short_run(runs_of_table(tt), k);
    const int* ps = tt.work + 4 * tt.m + run.x;
    float sq = 0.f;
    for (int c = lane; c - lane < dim; c += 32) {
      float g = 0.f;
      if (c < dim)
        for (int r = 0; r < run.y; ++r)
          g = Elem<T>::add(
              g, Elem<T>::load(rows + static_cast<long long>(ps[r]) * dim + c));
      if (c < dim) sq = __fadd_rn(sq, __fmul_rn(g, g));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sq = __fadd_rn(sq, __shfl_xor_sync(kFull, sq, o));
    const float total = __shfl_sync(kFull, sq, 0);  // lane 0's order
    const float a =
        __fadd_rn(acc[run.z], __fdiv_rn(total, static_cast<float>(dim)));
    const float denom = __fadd_rn(__fsqrt_rn(a), eps);
    for (int c = lane; c < dim; c += 32) {
      float g = 0.f;
      for (int r = 0; r < run.y; ++r)
        g = Elem<T>::add(
            g, Elem<T>::load(rows + static_cast<long long>(ps[r]) * dim + c));
      const float stp = Elem<T>::round(__fdiv_rn(__fmul_rn(lr, g), denom));
      T* dst = store + static_cast<long long>(run.z) * dim + c;
      Elem<T>::store(dst, __fsub_rn(Elem<T>::load(dst), stp));
    }
    __syncwarp();  // every lane has read acc[row]
    if (lane == 0) acc[run.z] = a;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the long runs' grid
}

// One table of a group pull: its store, indices and fresh output, the
// launch's first item on it, and its items (pieces of 2^lgw bytes: 16, 8,
// 4 or 2, as its row bytes and pointers allow) per row.
struct GatherTable {
  const void* store;
  const int* idx;
  void* out;
  long long first;
  int vpr, lgw, S, rps;
};
struct GatherGroup {
  int count;
  GatherTable t[kMaxTables];
};
static_assert(sizeof(GatherTable) == 48, "table layout");
static_assert(sizeof(GatherGroup) + 16 <= 4096, "kernel parameter size");

template <typename V>
__device__ __forceinline__ void copy_item(const GatherTable& d, long long u) {
  const long long j = u / d.vpr;
  const int v = static_cast<int>(u - j * d.vpr);
  const int r = flat_row(d.idx[j], d.S, d.rps);
  static_cast<V*>(d.out)[u] =
      r >= 0 ? static_cast<const V*>(d.store)[static_cast<long long>(r) *
                                                   d.vpr + v]
             : V();
}

// The pull of every table of a group in one launch: thread t copies item
// t of the launch, in the table whose first item is the last at or below
// t (a binary search of the table), at that table's width.
__global__ void gather_group_kernel(const GatherGroup grp, long long items) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  if (t >= items) return;
  int lo = 0, hi = grp.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (grp.t[mid].first <= t) lo = mid; else hi = mid - 1;
  }
  const GatherTable& d = grp.t[lo];
  const long long u = t - d.first;
  switch (d.lgw) {
    case 4: copy_item<uint4>(d, u); break;
    case 3: copy_item<uint2>(d, u); break;
    case 2: copy_item<unsigned int>(d, u); break;
    default: copy_item<unsigned short>(d, u); break;
  }
}

bool aligned(const void* p, unsigned long long n) {
  return (reinterpret_cast<unsigned long long>(p) % n) == 0;
}

unsigned int blocks_of(long long n, int threads) {
  return static_cast<unsigned int>((n + threads - 1) / threads);
}

// CTAs a kernel keeps resident on the card: asked of the occupancy API
// once per kernel, block size, shared memory and device, then kept.  A
// kernel's dynamic shared memory limit is raised to the largest size it has
// been launched with (never lowered).  Pushes may launch from several host
// threads at once (ctypes drops the interpreter lock), hence the mutex.
struct Resident {
  const void* kernel;
  int device, threads;
  size_t smem;
  long long blocks;
};
Resident g_resident[64];
int g_nresident = 0;
std::mutex g_resident_mu;

template <typename K>
long long resident_blocks(K kernel, int threads, size_t smem) {
  std::lock_guard<std::mutex> hold(g_resident_mu);
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  size_t allowed = 48 * 1024;
  for (int i = 0; i < g_nresident; ++i) {
    const Resident& r = g_resident[i];
    if (r.kernel != key || r.device != dev) continue;
    if (r.smem == smem && r.threads == threads) return r.blocks;
    if (r.smem > allowed) allowed = r.smem;
  }
  if (smem > allowed)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  int sms = 0, per_sm = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                smem);
  const long long n = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (g_nresident < 64)
    g_resident[g_nresident++] = {key, dev, threads, smem, n};
  return n;
}

// Clusters of `size` CTAs of a kernel that the card runs at once, asked of
// the occupancy API once per kernel, shared memory, size and device (the
// dynamic shared memory limit raised as resident_blocks does; sizes above
// 8 allowed).
struct ResidentClusters {
  const void* kernel;
  int device, size;
  size_t smem;
  long long clusters;
};
ResidentClusters g_clusters[32];
int g_nclusters = 0;

template <typename K>
long long resident_clusters(K kernel, int threads, size_t smem, int size) {
  resident_blocks(kernel, threads, smem);  // raises the smem limit
  std::lock_guard<std::mutex> hold(g_resident_mu);
  int dev = 0;
  cudaGetDevice(&dev);
  const void* key = reinterpret_cast<const void*>(kernel);
  for (int i = 0; i < g_nclusters; ++i) {
    const ResidentClusters& r = g_clusters[i];
    if (r.kernel == key && r.device == dev && r.size == size &&
        r.smem == smem)
      return r.clusters;
  }
  if (size > 8)
    cudaFuncSetAttribute(kernel,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(size);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, kernel, &cfg) != cudaSuccess ||
      n < 1)
    n = 1;
  if (g_nclusters < 32) g_clusters[g_nclusters++] = {key, dev, size, smem, n};
  return n;
}

unsigned int grid_of(long long resident, long long most) {
  return static_cast<unsigned int>(resident < most ? resident : most);
}

// The sort's cluster size: one CTA per kSortGrow entries, at most
// kSortCluster (always kSortCluster above the capacity in shared memory).
int sort_cluster(long long m) {
  const long long c = (m + kSortGrow - 1) / kSortGrow;
  return static_cast<int>(c < 1 ? 1 : (c > kSortCluster ? kSortCluster : c));
}

// A programmatic dependent launch: the kernel may start before the one
// ahead of it on the stream has finished (it waits with
// griddepcontrol.wait where it must).
void beside(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& attr, dim3 grid,
            int threads, size_t smem, cudaStream_t st) {
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
}

// The sorts of a push's tables: one launch, one cluster per table, its
// size set by the largest table.
template <int N>
int launch_sort(const PushGroup<N>& grp, cudaStream_t st) {
  static const cudaError_t ready = [] {
    cudaError_t e = cudaFuncSetAttribute(
        sort_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSortSmem);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(
        sort_kernel<N>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }();
  if (ready != cudaSuccess) return static_cast<int>(ready);
  int C = 1;
  for (int i = 0; i < grp.count; ++i) C = max(C, sort_cluster(grp.t[i].m));
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr;
  cfg.gridDim = dim3(C * grp.count);
  cfg.blockDim = dim3(kSortThreads);
  cfg.dynamicSmemBytes = kSortSmem;
  cfg.stream = st;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(C);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, sort_kernel<N>, grp);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The long and short runs of a push's tables (sorted just before on the
// same stream): two launches.
template <typename T, bool PROBE, int N>
int launch_push(const PushGroup<N>& grp, bool adagrad, float lr, float eps,
                long long* probe, cudaStream_t st) {
  // The long runs first: the hottest row's walk is the longest piece.
  // Clusters of G CTAs, kGroup columns each, G for the launch's widest
  // table; a cluster takes G / Gt runs at once of a table whose runs need
  // Gt CTAs (a bundle).  As many clusters as run at once, up to the most
  // bundles the tables' lists can hold.
  constexpr int kLg = (sizeof(T) == 4 ? 2 : 1) + (kGroup == 32 ? 5 : 4);
  int G = 1, widest = 0;
  long long most_long = 0, short_items = 0, m_all = 0;
  for (int i = 0; i < grp.count; ++i) {
    const PushTable& t = grp.t[i];
    G = max(G, long_ctas(t.dim));
    widest = max(widest, t.dim);
    short_items += static_cast<long long>(t.m) * ((t.dim + 3) / 4);
    m_all += t.m;
  }
  for (int i = 0; i < grp.count; ++i) {  // bundles of G / Gt runs
    const int pb = G / long_ctas(grp.t[i].dim);
    most_long += (grp.t[i].m / (kLong + 1) + 1 + pb - 1) / pb;
  }
  // Rows per slot: a multiple of kAhead, at most kRingRows, and at most 8
  // per producer thread (each copies 16 bytes of a row of kGroup values).
  const int per =
      (kLongThreads - 32) / (kGroup * static_cast<int>(sizeof(T)) / 16);
  const int rb = min(min(kRingRows, (kRingBytes / kStages) >> kLg), 8 * per) &
                 ~(kAhead - 1);
  const size_t smem =
      (static_cast<size_t>(kStages * rb + kAhead) << kLg) +
      (adagrad ? static_cast<size_t>(widest) * sizeof(float) : 0);
  auto lk = adagrad ? long_runs_kernel<T, true, PROBE, N>
                    : long_runs_kernel<T, false, PROBE, N>;
  const long long fit = resident_clusters(lk, kLongThreads, smem, G);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attrs[2];
  beside(cfg, attrs[0], dim3(G * grid_of(fit, most_long)), kLongThreads, smem,
         st);
  attrs[1].id = cudaLaunchAttributeClusterDimension;
  attrs[1].val.clusterDim.x = static_cast<unsigned>(G);
  attrs[1].val.clusterDim.y = 1;
  attrs[1].val.clusterDim.z = 1;
  cfg.attrs = attrs;
  cfg.numAttrs = 2;
  cudaError_t err = cudaLaunchKernelEx(&cfg, lk, grp, rb, lr, eps, probe);
  if (err != cudaSuccess) return static_cast<int>(err);

  // The short runs beside the long ones: they start once every long-run
  // CTA has passed its wait for the sort.
  if (adagrad) {
    auto sk = adagrad_short_kernel<T, N>;
    beside(cfg, attrs[0],
           dim3(grid_of(resident_blocks(sk, 256, 0), (m_all + 7) / 8)), 256,
           0, st);
    err = cudaLaunchKernelEx(&cfg, sk, grp, lr, eps);
  } else {
    auto sk = scatter_short_kernel<T, N>;
    beside(cfg, attrs[0],
           dim3(grid_of(resident_blocks(sk, 256, 0), (short_items + 255) / 256)),
           256, 0, st);
    err = cudaLaunchKernelEx(&cfg, sk, grp);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// A push's descriptor of one table: rows of int64 words (store, acc or 0,
// rows, indices, work, m, dim, S, rps).  The tables must not share a store.
template <typename T>
bool push_table(const long long* w, PushTable& t) {
  t.store = reinterpret_cast<void*>(w[0]);
  t.acc = reinterpret_cast<float*>(w[1]);
  t.rows = reinterpret_cast<const void*>(w[2]);
  t.idx = reinterpret_cast<const int*>(w[3]);
  t.work = reinterpret_cast<int*>(w[4]);
  const long long m = w[5], dim = w[6], S = w[7], rps = w[8];
  const bool ok = m >= 1 && m < (1ll << 31) && dim >= 1 && dim < (1ll << 31) &&
                  S >= 1 && rps >= 1 && S * rps < (1ll << 31) - 1;
  t.m = static_cast<int>(m);
  t.dim = static_cast<int>(dim);
  t.S = static_cast<int>(S);
  t.rps = static_cast<int>(rps);
  t.bits = ok ? 32 - __builtin_clz(static_cast<unsigned>(S * rps)) : 0;
  t.by16 = aligned(t.rows, 16) && (dim * sizeof(T)) % 16 == 0;
  t.vec = dim % 4 == 0 && aligned(t.rows, 4 * sizeof(T));
  return ok;
}

template <typename T>
bool push_group(const long long* tables, int count, bool adagrad,
                PushGroup<kMaxTables>& grp) {
  if (count < 1 || count > kMaxTables) return false;
  grp.count = count;
  for (int i = 0; i < count; ++i) {
    const PushTable& t = grp.t[i];
    if (!push_table<T>(tables + 9ll * i, grp.t[i]) || t.store == nullptr ||
        t.rows == nullptr || t.idx == nullptr || t.work == nullptr ||
        (adagrad && t.acc == nullptr))
      return false;
  }
  return true;
}

// A single table's sort or push: a group of one (the C entries of one table
// check their own arguments).
template <typename T>
PushGroup<1> one_table(void* store, void* acc, const void* rows,
                       const void* idx, void* work, long long m, int dim,
                       int S, int rps) {
  const long long w[9] = {reinterpret_cast<long long>(store),
                          reinterpret_cast<long long>(acc),
                          reinterpret_cast<long long>(rows),
                          reinterpret_cast<long long>(idx),
                          reinterpret_cast<long long>(work),
                          m, dim, S, rps};
  PushGroup<1> grp{};
  grp.count = 1;
  push_table<T>(w, grp.t[0]);
  return grp;
}

// The pull of `count` (<= 48) tables in one launch, each a row of 7 int64
// words: (store, indices, out, m, row bytes, S, rps); one table's is a
// group of one.
int gather_group(const long long* tables, int count, cudaStream_t st) {
  if (count < 1 || count > kMaxTables)
    return static_cast<int>(cudaErrorInvalidValue);
  GatherGroup grp{};
  long long items = 0;
  for (int i = 0; i < count; ++i) {
    const long long* w = tables + 7ll * i;
    GatherTable& d = grp.t[grp.count];
    d.store = reinterpret_cast<const void*>(w[0]);
    d.idx = reinterpret_cast<const int*>(w[1]);
    d.out = reinterpret_cast<void*>(w[2]);
    const long long m = w[3], row_bytes = w[4];
    if (m < 0 || row_bytes < 2 || row_bytes >= (1ll << 31) || w[5] < 1 ||
        w[6] < 1 || d.store == nullptr || d.idx == nullptr ||
        d.out == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    int lgw = 4;
    while (lgw > 0 && (row_bytes % (1 << lgw) || !aligned(d.store, 1 << lgw) ||
                       !aligned(d.out, 1 << lgw)))
      --lgw;
    if (lgw == 0) return static_cast<int>(cudaErrorInvalidValue);
    if (m == 0) continue;
    d.first = items;
    d.vpr = static_cast<int>(row_bytes >> lgw);
    d.lgw = lgw;
    d.S = static_cast<int>(w[5]);
    d.rps = static_cast<int>(w[6]);
    items += m * d.vpr;
    ++grp.count;
  }
  if (items == 0) return 0;
  gather_group_kernel<<<blocks_of(items, 256), 256, 0, st>>>(grp, items);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The sort of a push: the flat row of every update, sorted stably, and the
// run lists, into `work` (9m + 3 ints; see Work).  One cluster launch.
int pstt_sparse_sort(const void* idx, void* work, long long m, int S, int rps,
                     void* stream) {
  if (m <= 0) return 0;
  if (m >= (1ll << 31) || S < 1 || rps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_sort(one_table<float>(nullptr, nullptr, nullptr, idx, work, m,
                                      1, S, rps),
                     static_cast<cudaStream_t>(stream));
}

// dtype: 0 float32, 1 bfloat16.  work: filled by pstt_sparse_sort just
// before, on the same stream.
int pstt_sparse_scatter_add(void* store, const void* rows, void* work,
                            long long m, int dim, int dtype, void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_push<__nv_bfloat16, false>(
        one_table<__nv_bfloat16>(store, nullptr, rows, nullptr, work, m, dim,
                                 1, 1),
        false, 0.f, 0.f, nullptr, st);
  return launch_push<float, false>(
      one_table<float>(store, nullptr, rows, nullptr, work, m, dim, 1, 1),
      false, 0.f, 0.f, nullptr, st);
}

int pstt_sparse_row_adagrad(void* store, void* acc, const void* rows,
                            void* work, long long m, int dim, float lr,
                            float eps, int dtype, void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_push<__nv_bfloat16, false>(
        one_table<__nv_bfloat16>(store, acc, rows, nullptr, work, m, dim, 1,
                                 1),
        true, lr, eps, nullptr, st);
  return launch_push<float, false>(
      one_table<float>(store, acc, rows, nullptr, work, m, dim, 1, 1), true,
      lr, eps, nullptr, st);
}

// The sum push with the clock probe in its long-run walk (f32 or bf16):
// probe[4h ... 4h + 3] = (length, SM cycles of the walk's first tile, of
// its consumer thread 0's waits, of its producer thread 0's waits) of long
// run h; 4 * (m / (kLong + 1) + 1) values.
int pstt_sparse_walk_probe(void* store, const void* rows, void* work,
                           long long m, int dim, int dtype, void* probe,
                           void* stream) {
  if (m <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  auto* pr = static_cast<long long*>(probe);
  if (dtype == 1)
    return launch_push<__nv_bfloat16, true>(
        one_table<__nv_bfloat16>(store, nullptr, rows, nullptr, work, m, dim,
                                 1, 1),
        false, 0.f, 0.f, pr, st);
  return launch_push<float, true>(
      one_table<float>(store, nullptr, rows, nullptr, work, m, dim, 1, 1),
      false, 0.f, 0.f, pr, st);
}

// The sorts of a group push of `count` (<= 48) tables, each described by a
// row of 9 int64 words: (store, acc or 0, update rows, indices, work, m,
// dim, S, rps); each table's work (9m + 3 ints) is its own.  One cluster
// launch.
int pstt_sparse_sort_group(const long long* tables, int count, void* stream) {
  PushGroup<kMaxTables> grp;
  if (!push_group<float>(tables, count, false, grp))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_sort(grp, static_cast<cudaStream_t>(stream));
}

// The long and short runs of a group push, after pstt_sparse_sort_group on
// the same tables and stream: every table of one dtype (0 float32, 1
// bfloat16); adagrad: 0 the sum push, 1 row-wise Adagrad (each table's acc
// given).  Two launches.
int pstt_sparse_push_group(const long long* tables, int count, int dtype,
                           int adagrad, float lr, float eps, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  PushGroup<kMaxTables> grp;
  if (dtype == 1) {
    if (!push_group<__nv_bfloat16>(tables, count, adagrad != 0, grp))
      return static_cast<int>(cudaErrorInvalidValue);
    return launch_push<__nv_bfloat16, false>(grp, adagrad != 0, lr, eps,
                                             nullptr, st);
  }
  if (!push_group<float>(tables, count, adagrad != 0, grp))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_push<float, false>(grp, adagrad != 0, lr, eps, nullptr, st);
}

int pstt_sparse_gather_rows(const void* store, const void* idx, void* out,
                            long long m, int row_bytes, int S, int rps,
                            void* stream) {
  if (m <= 0) return 0;
  const long long w[7] = {reinterpret_cast<long long>(store),
                          reinterpret_cast<long long>(idx),
                          reinterpret_cast<long long>(out), m, row_bytes, S,
                          rps};
  return gather_group(w, 1, static_cast<cudaStream_t>(stream));
}

// The pull of a group of `count` (<= 48) tables in one launch, each a row
// of 7 int64 words: (store, indices, out, m, row bytes, S, rps).
int pstt_sparse_gather_group(const long long* tables, int count,
                             void* stream) {
  return gather_group(tables, count, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
