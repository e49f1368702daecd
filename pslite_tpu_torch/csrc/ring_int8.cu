// The int8 wire-compressed ring push_pull / push on one Hopper card: one
// launch per call, each region walked on chip by one thread block cluster,
// or by a group of clusters that meet each hop's maximum in global memory.
//
// Replaces the compressed variant of the Pallas TPU ring kernel of
// pslite_tpu/ops/ring_collective.py (_ring_call :389, pallas_call :445, with
// compress=True: quantize_to_send :251-262, dequant_recv :268-271, the
// reduce-scatter :285-297, the owner's sum :307-310, the all-gather
// :343-378), for the 1-D ring and for the (dp, kv) sub-rings of the 2-D data
// plane (the layout of ring_geometry.cuh, as a table of regions).
//
// What the TPU ring computes.  Each half-chunk ("region") of each chunk walks
// the ring as in ring_push_pull.cu, but every hop sends int8 codes with ONE
// absmax scale for the whole region:
//   hop 1 quantizes the first rank's grads of the region;
//   hop k = 2..n-1 dequantizes, adds its own grads, and re-quantizes:
//     v = fmaf(q, scale, g), scale = max(amax(|v| over the region) * (1/127),
//     1e-30), q = clip(rint(v / scale), -127, 127);
//   the owner (hop n) sums fmaf(q, scale, g[c]) and applies the handle to the
//   store at full precision (0 = sum, 1 = assign, 2 = sgd:lr);
//   the all-gather quantizes the updated region ONCE at the owner and every
//   rank, the owner included, gets q * scale as its pulled value.
// On a 1-D ring the store keeps the full-precision value; on the 2-D
// sub-rings the engine keeps the pulled value as the new store
// (pslite_tpu/parallel/engine.py:735-750), so store_takes_pulled writes it
// (once, at the gather).  fmaf and the reciprocal are written out because XLA
// contracts the TPU kernel's `q * scale + g` into one FMA and compiles
// `amax / 127.0` as a multiplication by the f32 reciprocal.
//
// Bound: HBM bandwidth.  The function must read n grads rows and the store and
// write the store and pulled: (n+3)*4*P bytes ((n+2)*4*P for a 1-D push), as
// the uncompressed ring (on one card the int8 payload never crosses a link).
//
// Design.  A hop needs the absmax of its whole region (up to 2,560,000 values
// at the main path's shapes) before the next hop can quantize, so no thread
// can walk its elements alone.  The TPU keeps the region in VMEM for the
// whole walk; here G thread block CLUSTERS of C CTAs each (C in 1..16, G in
// 1..32, chosen per launch by the wrapper) own one region (shard b,
// sub-chunk c, direction d of one bucket) and keep it in shared memory:
//   - the region [start, start + len) (a table row computed once per
//     geometry by ops/ring_collective.py) is cut into G * C contiguous
//     slices of round4(ceil(len / (G * C))) values, slice member * C + r to
//     CTA r of the group's cluster `member`;
//   - each CTA keeps the first `smem_floats` values of its slice in dynamic
//     shared memory (at most kMaxSmemFloats = 57,344 f32 = 224 KiB, so a
//     region's CTAs hold G * C * 57,344 values); the rest of a longer slice
//     spills to the bucket's `scratch`, a [padded] f32 tensor indexed like
//     the bucket, which the wrapper allocates only for a bucket that spills;
//   - every hop reads one grads row once and updates the partial sums in
//     place; each CTA reduces |v| over its slice and writes it to its own
//     shared slot, and after one cluster barrier every warp reads the C slots
//     of the cluster through distributed shared memory (C = 1: its own
//     slot, behind a barrier of one CTA).  Two slots alternate by hop
//     parity, so one barrier per hop suffices (a slot is rewritten two hops
//     later, after every peer has passed the barrier that follows its read).
//     The barrier is split (arrive, then wait): between the two, each thread
//     issues its first batch of the next hop's loads, which do not depend on
//     the scale;
//   - each thread keeps kUnroll = 8 float4 loads in flight (64 KiB per SM);
//   - the owner hop reads the store; the gather writes pulled (and, 2-D, the
//     store) from the values still on chip.
// The launch reads each grads row, the store and nothing else once and writes
// the store and pulled once: exactly the bound's bytes when nothing spills.
// A spilled value costs 8 more bytes per hop (written and read back).  No
// memsets, and no atomics on the data (a region group's counters below are
// the only ones); a max does not depend on order, and every element's
// arithmetic is that of the plain version, so the result is bit-exact and
// does not depend on C or G.  The IEEE division of the quantizer is the
// costliest instruction sequence per value; quant() replaces it by a
// multiplication by the reciprocal wherever that provably rounds to the same
// integer.
//
// Region groups (G > 1).  One cluster is at most 16 CTAs, and the card runs
// only 7 clusters of 10-16 CTAs at once (15 of 8, 66 of 2, 132 of 1), so a
// launch of few long regions (8 per process across processes, 4 at n = 2)
// left most SMs idle or took two waves, and 16 CTAs could not hold a
// 2,560,000-value region.  A group lets G clusters walk one region: after
// the cluster barrier of hop e, CTA 0 of each cluster writes the cluster's
// maximum to its slot of the region row's exchange words in global memory
// (one relaxed 64-bit store of (e << 32 | bits), so the number and the
// value arrive together), and in every CTA warp 0's first G lanes each poll
// one slot (relaxed loads at GPU scope) until it holds exchange e, then take
// the maximum; a CTA barrier hands it to the other warps.  Slots alternate
// by the parity of e: a cluster writes exchange e + 2 only after every
// member's exchange e + 1 arrived, which each wrote after reading e.  After
// the walk's last exchange every CTA adds one to the row's done count
// (acquire-release), and the group's last CTA zeroes the row's words, so
// the next launch finds them zeroed: a CUDA graph replays a captured launch
// with the same words, so no per-launch epoch from the host could serve.
// The clusters of a group wait for one another, so they must all be
// resident: the wrapper takes G > 1 only where regions * G clusters fit the
// card at once (cudaOccupancyMaxActiveClusters), the C entry refuses a grid
// that does not (cudaErrorCooperativeLaunchTooLarge), and the launch is
// cooperative (the H100's driver takes that attribute beside a cluster
// dimension; a driver that refused it would fail the launch).  Two
// launches that ran at once on the same words would read each other's
// slots, so the wrapper keeps the words per size and stream: launches on
// one stream run in order.  Every flag a CTA waits on belongs to this launch's own CTAs
// in this process's context, so the wait is safe while two processes
// time-slice the card (a context switch saves and restores the whole
// grid); no kernel of the port waits on a flag another process writes.
//
// One launch, many buckets.  A launch takes a table of up to 48 buckets
// (pointers, length, rank count, float4 flag) BY VALUE as its parameter, as
// ring_push_pull.cu's grouped kernel does, and a device table of region rows
// (start, len, chunk, step, bucket) that spans all of them: G clusters per
// row.  The single push_pull/push is a launch over a table of one bucket; the
// engine's push_pull_group (the JAX engine's k ring kernels in one program,
// pslite_tpu/parallel/engine.py:1333-1433) puts the regions of every int8
// bucket of the call in one launch (the ResNet-50 trace: 528 regions of 36
// buckets, 128 to 65,536 values each).  The wrapper sorts the rows longest
// first, so the block scheduler hands the short regions to SMs as the long
// walks finish, and caches the table per group geometry on the device.  A
// bucket whose pointers or regions cannot take float4 runs the scalar walk
// inside the same launch (the <0> instantiation branches per cluster); the
// others keep float4.  Bound of a group: (n+3)*4*P bytes over its P values,
// the same as its single launches (the trace at 8 ranks: 1.124 GB, 335.7 us
// at 3.35 TB/s).
//
// Launch shape.  One (C, G) per launch.  C = 1 reads no peer's shared
// memory and G = 1 no global slot; a larger C or G holds more of a region
// on chip and walks it with more SMs, at the cost of barriers (a cluster's)
// and exchanges (a group's) per hop.  The wrapper asks
// cudaOccupancyMaxActiveClusters (pstt_ring_int8_occupancy) how many
// clusters of each size run at once and picks the shape with the least
// makespan of the rows' work, in bytes per CTA, assigned longest first to
// that many cluster slots, a group's exchanges and its one wave priced in
// (ring_collective.py int8_cost, fitted on the card).  On an H100 that is
// 16 clusters of 2 CTAs per region for n = 2's 4 regions and 8 of 2 for a
// process's 8 regions across processes: 128 CTAs in one wave, nothing
// spilled at 8 ranks and 28 % of each slice at n = 2 (64 % at one cluster
// of 16).  The main path's 16 regions keep one cluster of 16 CTAs (three
// waves): a one-wave group there would spill 29 % of every slice.  -Xptxas
// -v: the <4> instantiations take 112-128 registers a thread, all
// __launch_bounds__(512, 1) allows, so one CTA runs per SM whatever its
// shared memory; the occupancy query sees that too.
//
// What still limits it.  A region's n+1 sweeps are separated by cluster
// barriers (and, in a group, exchanges through L2), and after each one a
// CTA has only the loads it issued before the barrier in flight: one batch
// of 64 KiB per SM, so a one-wave launch of 128 CTAs streams about 2.2 of
// the card's 3.35 TB/s.  A short region (the trace's are 12K-65K values, a
// few thousand per CTA) spends a large share of its walk at the barriers,
// and one CTA per SM walks one region at a time.  The tail of the
// longest-first assignment leaves SMs idle at the end of a multi-wave
// launch, and a scalar bucket (odd region starts) reads one float per
// load.  Staging each hop's grads through shared memory with bulk copies
// (more bytes in flight without registers), or carrying two regions per
// CTA, is what would close the gap; PERF.md records the measured share of
// the bound.
//
// Across processes (pstt_ring_int8_peers): the compressed TPU kernel on a
// multi-process pod (pslite_tpu/parallel/engine.py:211-222 compresses the
// ring there too), for the 1-D ring and for the dp sub-rings.  Several
// worker processes share one card, each holding the grads rows and store
// pieces of its ranks in exchange memory the others map (as
// ring_push_pull.cu's K4 across processes).  The kernel is this one with the
// PEERS instantiation: a bucket of the table is one store piece of this
// process (its ranks' neighbouring chunks, or on 2-D a (kv shard, dp
// sub-chunk)), whose
// rank rows are read through a device table of n row addresses in place of
// Bucket.grads's [n, padded] base and stride, and whose store, pulled and
// scratch pointers address the piece (element `off` of the bucket at their
// index 0).  The launch covers only the regions of this process's pieces;
// each region is walked exactly as on one process, so the bits equal
// pstt_ring_int8 on the same rows whatever the launch shape.  On the 1-D
// ring the owner writes its full-precision store and, at the gather, the
// dequantized values of its pieces into its pulled area, from which every
// process's pull copies them (ring_gather_peers); on the 2-D sub-rings the
// store takes the dequantized values, as on one process.  Bound: the same
// bytes per owned value as one process's share of the ring, (n+3)*4 per
// value (n rows, the store read and written, pulled written); on one card
// the int8 payload saves no bytes, so this is a parity path.
//
// Launch: cudaLaunchKernelEx with a cluster dimension (and, for a region
// group, the cooperative attribute); 9-16 CTAs are non-portable cluster
// sizes (cudaFuncAttributeNonPortableClusterSizeAllowed).  A refused launch
// returns its error; nothing falls back.  The kernel and its launch helpers
// are in ring_int8.cuh; the GROUP instantiations compile in
// ring_int8_group.cu, in parallel with this file.

#include "ring_int8.cuh"

using namespace pstt_int8;

namespace {

template <bool PEERS>
int occupancy_of(int cluster, int smem_floats, int mode, int count,
                 int* max_clusters) {
  *max_clusters = 0;
  if (cluster < 1 || cluster > 16 || smem_floats < 0 ||
      smem_floats > kMaxSmemFloats || count < 1 || count > kMaxGroup)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch(mode, count, [&](auto vm, auto one) {
    return occupancy<decltype(vm)::value, decltype(one)::value, PEERS,
                     false>(cluster, smem_floats, max_clusters);
  }));
}

}  // namespace

extern "C" {

// One launch over `count` (1..48) buckets.  desc: `count` rows of 7 int64
// words: grads ([n, padded] f32, row w = rank w), store ([padded] f32,
// updated in place), pulled ([padded] f32 or NULL), scratch ([padded] f32
// or NULL; needed when a slice of one of the bucket's regions is longer
// than smem_floats), padded, n (>= 2), and 1 when every region of the
// bucket starts and ends on a multiple of 4 (float4 accesses, taken when
// the pointers are 16-byte aligned too).  regions: nregions rows of int64
// (start, length, chunk, step, bucket), each a contiguous range of its
// bucket, in the order the clusters are launched.  cluster: CTAs per
// cluster (1..16); groups: clusters per region (1..32; above 1 the whole
// grid must fit the card at once, or the launch is refused with
// cudaErrorCooperativeLaunchTooLarge); xchg: for groups > 1, nregions *
// (2 * groups + 1) zeroed uint64 words, 8-byte aligned, which every
// launch leaves zeroed (NULL for groups = 1); smem_floats: partial sums
// each CTA keeps in shared memory (a multiple of 4, at most 57,344).
// gather runs the all-gather (pulled and/or store_takes_pulled).
int pstt_ring_int8(const long long* desc, int count, const void* regions,
                   long long nregions, int cluster, int groups, void* xchg,
                   int smem_floats, int handle, float lr, int gather,
                   int store_takes_pulled, void* stream) {
  if (nregions <= 0) return 0;
  if (!valid_launch(count, cluster, groups, xchg, smem_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 1)
    return launch_group(false, desc, count, regions, nregions, cluster,
                        groups, xchg, smem_floats, handle, lr, gather,
                        store_takes_pulled, stream);
  return launch_desc<false, false>(desc, count, regions, nregions, cluster, 1,
                                   nullptr, smem_floats, handle, lr, gather,
                                   store_takes_pulled, stream);
}

// The launch across processes: `count` (1..48) store pieces of this
// process, desc rows of 9 int64 words: the device address of a table of the
// piece's n rank-row addresses (each row [padded] f32, a peer's mapped
// through CUDA IPC), store, pulled (or NULL) and scratch (or NULL) of the
// piece (bucket element `off` at index 0), padded, n (>= 2), the float4
// flag (every region of the piece, its rows and its offset multiples of 4
// values), off, and a zero.  regions: the rows (start, length, chunk,
// step, piece) of the regions inside the pieces, in launch order.  The rest
// as pstt_ring_int8.
int pstt_ring_int8_peers(const long long* desc, int count,
                         const void* regions, long long nregions, int cluster,
                         int groups, void* xchg, int smem_floats, int handle,
                         float lr, int gather, int store_takes_pulled,
                         void* stream) {
  if (nregions <= 0) return 0;
  if (!valid_launch(count, cluster, groups, xchg, smem_floats))
    return static_cast<int>(cudaErrorInvalidValue);
  if (groups > 1)
    return launch_group(true, desc, count, regions, nregions, cluster, groups,
                        xchg, smem_floats, handle, lr, gather,
                        store_takes_pulled, stream);
  return launch_desc<true, false>(desc, count, regions, nregions, cluster, 1,
                                  nullptr, smem_floats, handle, lr, gather,
                                  store_takes_pulled, stream);
}

// How many clusters of `cluster` CTAs, each CTA with smem_floats of dynamic
// shared memory, the card can run at once (0: none), for the instantiation
// a launch of `count` buckets in `mode` runs (4: every bucket float4, 1:
// none, 0: mixed).
int pstt_ring_int8_occupancy(int cluster, int smem_floats, int mode,
                             int count, int* max_clusters) {
  return occupancy_of<false>(cluster, smem_floats, mode, count, max_clusters);
}

// pstt_ring_int8_occupancy for the launch across processes.
int pstt_ring_int8_peers_occupancy(int cluster, int smem_floats, int mode,
                                   int count, int* max_clusters) {
  return occupancy_of<true>(cluster, smem_floats, mode, count, max_clusters);
}

}  // extern "C"
