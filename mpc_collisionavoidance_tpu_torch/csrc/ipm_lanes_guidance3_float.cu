// K3 instance for usv_guidance3 (nx=11, nu=1, one control box row,
// one state box row, no h rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_GUIDANCE3>(const FusedArgs<float>&,
                                           cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
