// K3 instance for usv_guidance4 (nx=4, nu=1, one control box row,
// no state box, no h rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_GUIDANCE4>(const FusedArgs<float>&,
                                           cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
