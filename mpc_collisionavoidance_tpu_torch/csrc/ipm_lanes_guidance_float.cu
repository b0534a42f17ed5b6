// K3 instance for usv_guidance (nx=10, nu=1, one control box row,
// 3 state box rows, no h rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_GUIDANCE>(const FusedArgs<float>&,
                                          cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
