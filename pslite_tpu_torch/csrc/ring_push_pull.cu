// Fused ring push_pull / push for n virtual ranks on one Hopper card.
//
// Replaces the Pallas TPU kernel of pslite_tpu/ops/ring_collective.py
// (_ring_call :389, pallas_call :445, body _kernel_body :98-386), reached by
// ring_push_pull (:468, with the all-gather) and ring_push (:497, without).
// The TPU kernel runs one bidirectional ring per device: a reduce-scatter over
// n-1 hops, the elementwise server handle on the owned chunk, then an
// all-gather over n-1 hops, with remote DMAs and credit semaphores between
// neighbours.  On one card every rank's grads row is already in the same
// device memory, so the hops need no messages: each output element is
// computed directly by one thread.
//
// What must match the TPU kernel is the ORDER of addition, which fixes the
// bits.  Chunk c (elements [c*chunk0, (c+1)*chunk0)) is split at `split`
// (half the tile-padded chunk, ring_chunk_len, when bidirectional): the first
// part travels direction 0 and sums ranks c+1, c+2, ..., c+n-1, c (mod n)
// left to right; the second travels direction 1 and sums c-1, c-2, ..., c.
// Each hop rounds to the working dtype (f32 arithmetic, rounded with
// __float2bfloat16_rn / __float2half_rn for 2-byte types), exactly as each
// hop of the TPU ring stores its partial sum in the dtype.  The handle then
// updates the store in place (0 = sum, 1 = assign, 2 = sgd:lr) and, for
// push_pull, the updated value is written to `pulled` (the all-gather).
//
// The (dp, kv) sub-rings of the 2-D data plane (pslite_tpu/parallel/
// engine.py:713-752, the kernel's `mesh_axes`, :160-175) use the same kernel:
// the grads rows are the A worker ranks, every kv shard runs its own A-rank
// ring over sub-chunks of `ksub` elements, and the padding sits at the end of
// each shard (ring_geometry.cuh).  The TPU runs the B sub-rings in one launch;
// here one launch covers all of them too.  The 1-D ring is the KV = false
// instantiation, which skips the shard division.
//
// Bound: HBM bandwidth.  Per element it reads n grads and the store and
// writes the store and (push_pull) pulled: (n+3)*P*bytes, (n+2)*P*bytes for
// push.  Design: one thread per 16-byte vector of outputs; the vector path
// needs the shard, chunk and split lengths to be multiples of the vector
// width (so a vector never straddles a boundary) and 16-byte aligned
// pointers, otherwise a scalar instantiation runs.  Neighbouring threads read
// neighbouring addresses of each rank row, so every row streams coalesced.
//
// Grouped launch (pstt_ring_group, ring_group_kernel): the counterpart of
// the JAX engine's push_pull_group program (pslite_tpu/parallel/engine.py:
// 1333-1433), which dispatches k ring kernels as one program.  Here one
// launch walks a table of up to 48 buckets of one dtype (the
// multi_tensor_apply pattern): each bucket's descriptor holds its pointers,
// its geometry, whether it takes vectors, and its first block; a block finds
// its bucket by binary search over the first blocks.  The table travels by
// value as the kernel's parameter, so nothing is copied to the device before
// the launch.  Every element runs the same ring_vector as the single launch,
// so a grouped bucket is bit-identical to its own pstt_ring_push_pull.
// A bucket that cannot take vectors (misaligned pointers, a geometry whose
// boundaries cut a vector) takes the scalar path inside the same launch.
// Bound: the same bytes as the k single launches, (n+3)*P*bytes for P
// elements over all buckets (the ResNet-50 trace, 8 ranks, f32: 1.124 GB,
// 335.7 us at 3.35 TB/s); what it saves is k-1 launches and their host cost.
// No PyTorch call walks a ring, so it has no library yardstick.  Faster
// later: buckets far below one wave (1,024 values) leave their SMs idle
// at the end of the launch; a persistent grid-stride form would keep every
// SM streaming across the bucket boundaries.
//
// Replay (pstt_ring_replay): T launches of ring_kernel from one C call, one
// per step of engine.replay; a persistent T-step kernel that keeps the store
// in registers between steps is later work.
//
// K4 across processes (pstt_ring_reduce_peers, pstt_ring_gather_peers): the
// same TPU kernel (pallas_call :445) on a multi-process pod, where its remote
// DMAs and credit semaphores run between devices of different processes
// (pslite_tpu's PS_ICI_MULTIHOST=1 mesh).  Here several worker processes
// share one card, each holding the rows and store shards of its own ranks in
// a slab of cudaMalloc memory (pstt_ipc_alloc; outside PyTorch's caching
// allocator, so an IPC handle's base is the slab's own) that every peer maps
// through cudaIpcOpenMemHandle.  One op, driven by parallel/engine.py:
// (1) each process writes its grads rows into its slab; (2) stream sync and
// a host barrier; (3) pstt_ring_reduce_peers: each process computes only its
// own ranks' chunks, reading every rank's row through a table of row
// pointers passed by value (as ring_group_kernel's table), with ring_sum and
// ring_apply, so the bits equal pstt_ring_push_pull's on the same n rows;
// (4) sync, barrier; (5) pstt_ring_gather_peers copies every owner's store
// shards into this process's pulled row; (6) sync, barrier before any
// process writes its slab or store again.  No kernel spins on a flag: two
// processes on one card without MPS time-slice, and a spinning kernel would
// hold the card from the peer it waits for.  Bound: HBM traffic, (n+2)*P*b
// for the reduce over all processes (n rows read, the store read and
// written) plus 2*P*b per process for its gather; at the 40 x 1 MB bucket,
// n = 8 ranks in 2 processes, f32: 14 * 40.96 MB = 573.4 MB, 171.2 us at
// 3.35 TB/s.  One process's launches move their share of that: its reduce
// (n+2)*count*b (count = its chunks' elements, P/2 here: 61.1 us), its
// gather 2*P*b (24.5 us).  The host barriers come on top and are timed
// apart.  Device flags with release/acquire semantics can replace them
// later.
//
// Later slice: ranks on several cards, where the TPU kernel's peer slots and
// credits become stores into NVLink peer pointers plus release/acquire flags.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstring>

#include "ring_geometry.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <> __device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// Round an f32 value to T's precision (identity for f32).
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

// Rank w's row of a grads tensor [n, padded] (one process holds every row).
template <typename T>
struct DenseRows {
  const T* __restrict__ g;
  long long padded;
  __device__ __forceinline__ const T* row(int r) const { return g + r * padded; }
};

// The ring walk of one thread's V consecutive elements at i0: the sum of
// every rank's values in the TPU ring's order, each hop rounded to T.
template <typename T, int V, bool KV, typename Rows>
__device__ __forceinline__ void ring_sum(const Rows& rows, const RingGeo& geo,
                                         long long i0, float (&acc)[V]) {
  const int n = geo.n;
  const RingPos pos = ring_pos<KV>(geo, i0);
  // Direction 0 walks c+1, c+2, ...; direction 1 walks c-1, c-2, ...
  const int step = pos.step;
  int r = ring_rank(pos, 1, n);
  {
    const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(rows.row(r) + i0);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = to_f<T>(g.v[e]);
  }
  for (int k = 2; k <= n; ++k) {
    r += step;
    if (r >= n) r -= n;
    const Pack<T, V> g = *reinterpret_cast<const Pack<T, V>*>(rows.row(r) + i0);
#pragma unroll
    for (int e = 0; e < V; ++e) acc[e] = rnd<T>(acc[e] + to_f<T>(g.v[e]));
  }
}

// The handle on V store values at `store` (updated in place), and the
// all-gather's copy at `pulled` unless it is NULL.
template <typename T, int V>
__device__ __forceinline__ void ring_apply(const float (&acc)[V],
                                           T* __restrict__ store,
                                           T* __restrict__ pulled, int handle,
                                           float lr) {
  Pack<T, V> s = *reinterpret_cast<const Pack<T, V>*>(store);
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const float sv = to_f<T>(s.v[e]);
    float out;
    if (handle == 0) {
      out = sv + acc[e];
    } else if (handle == 1) {
      out = acc[e];
    } else {
      out = sv - rnd<T>(lr * acc[e]);
    }
    s.v[e] = from_f<T>(out);
  }
  *reinterpret_cast<Pack<T, V>*>(store) = s;
  if (pulled != nullptr) *reinterpret_cast<Pack<T, V>*>(pulled) = s;
}

// One thread's V consecutive outputs at element i0: the ring walk, the
// handle, the store and pulled writes.  Shared by ring_kernel and
// ring_group_kernel, so a bucket of a group gets the bits of its own launch;
// ring_peers_kernel runs the same ring_sum and ring_apply.
template <typename T, int V, bool KV>
__device__ __forceinline__ void ring_vector(const T* __restrict__ grads,
                                            T* __restrict__ store,
                                            T* __restrict__ pulled,
                                            const RingGeo& geo,
                                            long long padded, long long i0,
                                            int handle, float lr) {
  float acc[V];
  ring_sum<T, V, KV>(DenseRows<T>{grads, padded}, geo, i0, acc);
  ring_apply<T, V>(acc, store + i0, pulled == nullptr ? nullptr : pulled + i0,
                   handle, lr);
}

template <typename T, int V, bool KV>
__global__ void ring_kernel(const T* __restrict__ grads, T* __restrict__ store,
                            T* __restrict__ pulled, RingGeo geo,
                            long long padded, long long nvec, int handle,
                            float lr) {
  const long long vi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vi >= nvec) return;
  ring_vector<T, V, KV>(grads, store, pulled, geo, padded, vi * V, handle, lr);
}

// One bucket of a grouped launch (pstt_ring_group).  80 bytes.
struct GroupBucket {
  const void* grads;
  void* store;
  void* pulled;
  long long padded;
  long long period;
  long long sub;
  long long split;
  long long first_block;  // the launch's first block on this bucket
  int n;
  int kv;   // 1: kv shards of `period` (the 2-D sub-rings)
  int vec;  // 1: 16-byte vectors; 0: one element per thread
  int unused;
};

// Buckets per launch.  The table is passed by value as a kernel parameter:
// 8 + 48 * 80 = 3,848 bytes, inside the 4 KiB that every CUDA 12 driver
// takes, so no copy to the device precedes the launch.  Longer groups
// take several launches.
constexpr int kMaxGroup = 48;

struct GroupTable {
  int count;
  GroupBucket b[kMaxGroup];
};

template <typename T>
__global__ void ring_group_kernel(const GroupTable table, int handle, float lr) {
  // The block's bucket: the last one whose first block is <= blockIdx.x.
  const long long blk = blockIdx.x;
  int lo = 0;
  int hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.b[mid].first_block <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const GroupBucket& d = table.b[lo];
  const RingGeo geo{d.period, d.sub, d.split, d.n};
  const long long padded = d.padded;
  const long long vi = (blk - d.first_block) * blockDim.x + threadIdx.x;
  const auto* g = static_cast<const T*>(d.grads);
  auto* s = static_cast<T*>(d.store);
  auto* p = static_cast<T*>(d.pulled);
  constexpr int V = 16 / sizeof(T);
  if (d.vec) {
    if (vi >= padded / V) return;
    if (d.kv) {
      ring_vector<T, V, true>(g, s, p, geo, padded, vi * V, handle, lr);
    } else {
      ring_vector<T, V, false>(g, s, p, geo, padded, vi * V, handle, lr);
    }
  } else {
    if (vi >= padded) return;
    if (d.kv) {
      ring_vector<T, 1, true>(g, s, p, geo, padded, vi, handle, lr);
    } else {
      ring_vector<T, 1, false>(g, s, p, geo, padded, vi, handle, lr);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

template <typename T, int V>
void launch_geo(const T* g, T* s, T* p, const RingGeo& geo, bool kv,
                long long padded, int handle, float lr, cudaStream_t stream) {
  const long long nvec = padded / V;
  const auto blocks = static_cast<unsigned int>((nvec + kThreads - 1) / kThreads);
  if (kv) {
    ring_kernel<T, V, true><<<blocks, kThreads, 0, stream>>>(
        g, s, p, geo, padded, nvec, handle, lr);
  } else {
    ring_kernel<T, V, false><<<blocks, kThreads, 0, stream>>>(
        g, s, p, geo, padded, nvec, handle, lr);
  }
}

// Whether a bucket takes 16-byte vectors: a vector never straddles a shard,
// chunk or direction boundary, and every pointer is 16-byte aligned.
template <typename T>
bool use_vectors(const void* grads, const void* store, const void* pulled,
                 const RingGeo& geo, bool kv) {
  constexpr int V = 16 / sizeof(T);
  return (!kv || geo.period % V == 0) && geo.sub % V == 0 &&
         (geo.split >= geo.sub || geo.split % V == 0) && aligned16(grads) &&
         aligned16(store) && (pulled == nullptr || aligned16(pulled));
}

template <typename T>
cudaError_t launch(const void* grads, void* store, void* pulled,
                   const RingGeo& geo, bool kv, long long padded, int handle,
                   float lr, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const auto* g = static_cast<const T*>(grads);
  auto* s = static_cast<T*>(store);
  auto* p = static_cast<T*>(pulled);
  if (use_vectors<T>(grads, store, pulled, geo, kv)) {
    launch_geo<T, V>(g, s, p, geo, kv, padded, handle, lr, stream);
  } else {
    launch_geo<T, 1>(g, s, p, geo, kv, padded, handle, lr, stream);
  }
  return cudaGetLastError();
}

bool valid_geo(int n, long long period, long long sub, long long padded) {
  return n >= 1 && period > 0 && sub > 0 && padded % period == 0;
}

// kDescWords int64 words per bucket of pstt_ring_group's table.
constexpr int kDescWords = 9;

template <typename T>
cudaError_t launch_group(const long long* desc, int count, int handle,
                         float lr, cudaStream_t stream, int* launched) {
  constexpr int V = 16 / sizeof(T);
  for (int first = 0; first < count; first += kMaxGroup) {
    GroupTable table{};
    long long blocks = 0;
    for (int i = first; i < count && i < first + kMaxGroup; ++i) {
      const long long* r = desc + static_cast<long long>(kDescWords) * i;
      GroupBucket& b = table.b[table.count++];
      b.grads = reinterpret_cast<const void*>(r[0]);
      b.store = reinterpret_cast<void*>(r[1]);
      b.pulled = reinterpret_cast<void*>(r[2]);
      b.padded = r[3];
      b.period = r[4];
      b.sub = r[5];
      b.split = r[6];
      b.n = static_cast<int>(r[7]);
      b.kv = r[8] != 0;
      b.unused = 0;
      if (b.padded <= 0 || !valid_geo(b.n, b.period, b.sub, b.padded))
        return cudaErrorInvalidValue;
      const RingGeo geo{b.period, b.sub, b.split, b.n};
      b.vec = use_vectors<T>(b.grads, b.store, b.pulled, geo, b.kv != 0);
      b.first_block = blocks;
      const long long nvec = b.vec ? b.padded / V : b.padded;
      blocks += (nvec + kThreads - 1) / kThreads;
    }
    if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
    ring_group_kernel<T><<<static_cast<unsigned int>(blocks), kThreads, 0,
                           stream>>>(table, handle, lr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    ++*launched;
  }
  return cudaSuccess;
}

// -- K4 across processes (pstt_ring_reduce_peers, pstt_ring_gather_peers) ----

// Ranks of a ring whose rows sit in several processes' memory: rank r's
// [padded] row at rows[r], mapped into this process through CUDA IPC (its
// own rows are plain device pointers).  2 KiB by value.
constexpr int kMaxPeers = 256;

struct PeerTable {
  long long lo;     // first element this launch computes
  long long count;  // elements it computes (this process's ranks' chunks)
  const void* rows[kMaxPeers];
};

template <typename T>
struct PeerRows {
  const PeerTable& t;
  __device__ __forceinline__ const T* row(int r) const {
    return static_cast<const T*>(t.rows[r]);
  }
};

// The chunks [lo, lo + count) of a 1-D ring: the same ring_sum over every
// rank's row, wherever it lives, and the same ring_apply on this process's
// store shards (store[0] is element lo).  No all-gather here: the owners'
// stores are copied out by gather_peers_kernel once every process is done.
template <typename T, int V>
__global__ void ring_peers_kernel(const PeerTable table, T* __restrict__ store,
                                  RingGeo geo, int handle, float lr) {
  const long long vi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (vi * V >= table.count) return;
  float acc[V];
  ring_sum<T, V, false>(PeerRows<T>{table}, geo, table.lo + vi * V, acc);
  ring_apply<T, V>(acc, store + vi * V, nullptr, handle, lr);
}

template <typename T>
cudaError_t launch_peers(const PeerTable& table, void* store,
                         const RingGeo& geo, int handle, float lr,
                         cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  bool vec = geo.sub % V == 0 && (geo.split >= geo.sub || geo.split % V == 0) &&
             table.lo % V == 0 && table.count % V == 0 && aligned16(store);
  for (int r = 0; r < geo.n; ++r) vec = vec && aligned16(table.rows[r]);
  auto* s = static_cast<T*>(store);
  if (vec) {
    const long long nvec = table.count / V;
    ring_peers_kernel<T, V><<<static_cast<unsigned int>((nvec + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(table, s, geo, handle, lr);
  } else {
    ring_peers_kernel<T, 1><<<static_cast<unsigned int>((table.count + kThreads - 1) / kThreads),
                              kThreads, 0, stream>>>(table, s, geo, handle, lr);
  }
  return cudaGetLastError();
}

// The all-gather across processes: segment s copies `len` elements from
// `src` (an owner's store shards, mapped or local) to pulled[off, off+len).
struct GatherSeg {
  const void* src;
  long long off;
  long long len;          // in units of the launch's word (16 or esize bytes)
  long long first_block;  // the launch's first block on this segment
};

constexpr int kMaxSegs = 64;  // processes per launch: 8 + 64 * 32 bytes
constexpr int kGatherUnroll = 4;  // words per thread, all loaded before any store

struct GatherTable {
  int count;
  GatherSeg s[kMaxSegs];
};

// A block copies kThreads * kGatherUnroll consecutive words of one segment;
// each thread issues its kGatherUnroll loads (kThreads apart, so a warp's
// accesses stay coalesced) before its stores, to keep more bytes in flight.
template <typename W>
__global__ void gather_peers_kernel(const GatherTable table, W* __restrict__ pulled) {
  const long long blk = blockIdx.x;
  int lo = 0;
  int hi = table.count - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (table.s[mid].first_block <= blk) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const GatherSeg& d = table.s[lo];
  const W* __restrict__ src = static_cast<const W*>(d.src);
  W* __restrict__ dst = pulled + d.off;
  const long long base =
      (blk - d.first_block) * blockDim.x * kGatherUnroll + threadIdx.x;
  W v[kGatherUnroll];
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * blockDim.x;
    if (i < d.len) v[u] = src[i];
  }
#pragma unroll
  for (int u = 0; u < kGatherUnroll; ++u) {
    const long long i = base + static_cast<long long>(u) * blockDim.x;
    if (i < d.len) dst[i] = v[u];
  }
}

template <typename W>
cudaError_t launch_gather(const long long* segs, int count, void* pulled,
                          long long unit, cudaStream_t stream) {
  GatherTable table{};
  long long blocks = 0;
  constexpr long long kWordsPerBlock = static_cast<long long>(kThreads) * kGatherUnroll;
  for (int i = 0; i < count; ++i) {
    const long long* r = segs + 3ll * i;
    GatherSeg& g = table.s[table.count++];
    g.src = reinterpret_cast<const void*>(r[0]);
    g.off = r[1] / unit;
    g.len = r[2] / unit;
    g.first_block = blocks;
    blocks += (g.len + kWordsPerBlock - 1) / kWordsPerBlock;
  }
  if (blocks == 0) return cudaSuccess;
  if (blocks >= (1ll << 31)) return cudaErrorInvalidValue;
  gather_peers_kernel<W><<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(
      table, static_cast<W*>(pulled));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  grads is [n, padded]
// row-major (row w = rank w's whole bucket), store is [padded] and is
// updated in place, pulled is [padded] or NULL for push-only.  The geometry
// (period, sub, split) is that of ring_geometry.cuh; kv = 0 is the 1-D ring
// (period must then equal padded).
int pstt_ring_push_pull(const void* grads, void* store, void* pulled,
                        int dtype, int n, long long period, long long sub,
                        long long split, int kv, long long padded, int handle,
                        float lr, void* stream) {
  if (padded <= 0) return 0;
  if (!valid_geo(n, period, sub, padded))
    return static_cast<int>(cudaErrorInvalidValue);
  const RingGeo geo{period, sub, split, n};
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch<float>(grads, store, pulled, geo, kv != 0, padded, handle,
                          lr, st);
      break;
    case 1:
      err = launch<__nv_bfloat16>(grads, store, pulled, geo, kv != 0, padded,
                                  handle, lr, st);
      break;
    case 2:
      err = launch<__half>(grads, store, pulled, geo, kv != 0, padded, handle,
                           lr, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// push_pull over `count` buckets of one dtype in ceil(count / 48) launches
// of ring_group_kernel.  desc is `count` rows of 9 int64 words: grads,
// store and pulled pointers, padded, period, sub, split, n, kv (each as in
// pstt_ring_push_pull; pulled must not be NULL).  *launched counts the
// launches made.
int pstt_ring_group(const long long* desc, int count, int dtype, int handle,
                    float lr, void* stream, int* launched) {
  *launched = 0;
  if (count <= 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_group<float>(desc, count, handle, lr, st, launched);
      break;
    case 1:
      err = launch_group<__nv_bfloat16>(desc, count, handle, lr, st, launched);
      break;
    case 2:
      err = launch_group<__half>(desc, count, handle, lr, st, launched);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(err);
}

// `steps` consecutive pstt_ring_push_pull launches on one store: grads is
// [steps, n, padded], and pulled is [steps, padded] (step t's all-gather in
// row t) or NULL for push-only steps.  One C call per replay, so the
// Python wrapper's cost is paid once, not once per step.
int pstt_ring_replay(const void* grads, void* store, void* pulled, int dtype,
                     int n, long long period, long long sub, long long split,
                     int kv, long long padded, int handle, float lr, int steps,
                     void* stream) {
  if (dtype < 0 || dtype > 2) return static_cast<int>(cudaErrorInvalidValue);
  const long long bytes = dtype == 0 ? 4 : 2;
  for (int t = 0; t < steps; ++t) {
    const auto* g = static_cast<const char*>(grads) +
                    static_cast<long long>(t) * n * padded * bytes;
    auto* p = pulled == nullptr
                  ? nullptr
                  : static_cast<char*>(pulled) +
                        static_cast<long long>(t) * padded * bytes;
    const int err = pstt_ring_push_pull(g, store, p, dtype, n, period, sub,
                                        split, kv, padded, handle, lr, stream);
    if (err != 0) return err;
  }
  return 0;
}

// -- K4 across processes --------------------------------------------------------

// The reduce of the ring over n ranks whose [padded] rows are at rows[0..n)
// (n int64 device addresses, peers' rows mapped through pstt_ipc_open): the
// elements [lo, lo + count) of a 1-D ring of chunks `sub` split at `split`
// are summed in the TPU ring's order, the handle updates store[0, count) in
// place (store[0] is element lo).  One launch.
int pstt_ring_reduce_peers(const long long* rows, int n, void* store,
                           long long lo, long long count, int dtype,
                           long long sub, long long split, long long padded,
                           int handle, float lr, void* stream) {
  if (count <= 0) return 0;
  if (n < 1 || n > kMaxPeers || !valid_geo(n, padded, sub, padded) || lo < 0 ||
      lo + count > padded)
    return static_cast<int>(cudaErrorInvalidValue);
  PeerTable table{};
  table.lo = lo;
  table.count = count;
  for (int r = 0; r < n; ++r) table.rows[r] = reinterpret_cast<const void*>(rows[r]);
  const RingGeo geo{padded, sub, split, n};
  auto st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_peers<float>(table, store, geo, handle, lr, st));
    case 1:
      return static_cast<int>(launch_peers<__nv_bfloat16>(table, store, geo, handle, lr, st));
    case 2:
      return static_cast<int>(launch_peers<__half>(table, store, geo, handle, lr, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The all-gather across processes: `count` segments of 3 int64 words
// (source address, destination offset, length; offsets and lengths in
// elements of esize bytes) copied into `pulled`, one launch.  Every source
// and the destination aligned to 16 bytes, with 16-byte multiples, take
// 16-byte words.
int pstt_ring_gather_peers(const long long* segs, int count, void* pulled,
                           int esize, void* stream) {
  if (count <= 0) return 0;
  if (count > kMaxSegs || (esize != 2 && esize != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  bool vec = aligned16(pulled);
  long long bytes[3 * kMaxSegs];
  for (int i = 0; i < 3 * count; ++i)
    bytes[i] = (i % 3 == 0) ? segs[i] : segs[i] * esize;
  for (int i = 0; i < count; ++i)
    vec = vec && aligned16(reinterpret_cast<const void*>(bytes[3 * i])) &&
          bytes[3 * i + 1] % 16 == 0 && bytes[3 * i + 2] % 16 == 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec) return static_cast<int>(launch_gather<uint4>(bytes, count, pulled, 16, st));
  if (esize == 4)
    return static_cast<int>(launch_gather<unsigned int>(bytes, count, pulled, 4, st));
  return static_cast<int>(launch_gather<unsigned short>(bytes, count, pulled, 2, st));
}

// Exchange memory for the cross-process ring: `bytes` of device memory from
// cudaMalloc, outside PyTorch's caching allocator, so that an IPC handle's
// base is the slab's own address; zero-filled.
int pstt_ipc_alloc(int device, long long bytes, void** out) {
  *out = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMalloc(out, static_cast<size_t>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaMemset(*out, 0, static_cast<size_t>(bytes));
  if (err == cudaSuccess) err = cudaDeviceSynchronize();
  return static_cast<int>(err);
}

int pstt_ipc_free(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaFree(ptr));
}

// The 64-byte IPC handle of a slab from pstt_ipc_alloc.
int pstt_ipc_export(int device, void* ptr, void* handle) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  err = cudaIpcGetMemHandle(&h, ptr);
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return static_cast<int>(err);
}

// Map another process's slab into this one; *out is its base here.
int pstt_ipc_open(int device, const void* handle, void** out) {
  *out = nullptr;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(out, h, cudaIpcMemLazyEnablePeerAccess));
}

int pstt_ipc_close(int device, void* ptr) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

}  // extern "C"
