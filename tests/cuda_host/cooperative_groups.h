// Host stand-in (tests/cuda_host/cuda_runtime.h): one block, no cluster.
#pragma once
namespace cooperative_groups {
struct cluster_group {
  void sync() {}
  int block_rank() { return 0; }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
