// Region groups of the int8 ring (G > 1 clusters per region): the
// kernel's GROUP instantiations, compiled apart from ring_int8.cu so that
// the two build in parallel.  ring_int8.cu's note describes the design.

#include "ring_int8.cuh"

namespace pstt_int8 {

int launch_group(bool peers, const long long* desc, int count,
                 const void* regions, long long nregions, int cluster,
                 int groups, void* xchg, int smem_floats, int handle,
                 float lr, int gather, int store_takes_pulled, void* stream) {
  return peers
             ? launch_desc<true, true>(desc, count, regions, nregions,
                                       cluster, groups, xchg, smem_floats,
                                       handle, lr, gather, store_takes_pulled,
                                       stream)
             : launch_desc<false, true>(desc, count, regions, nregions,
                                        cluster, groups, xchg, smem_floats,
                                        handle, lr, gather,
                                        store_takes_pulled, stream);
}

}  // namespace pstt_int8
