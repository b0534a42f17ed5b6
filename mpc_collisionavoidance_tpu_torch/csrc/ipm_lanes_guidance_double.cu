// K3 instance for usv_guidance (nx=10, nu=1, one control box row,
// 3 state box rows, no h rows), in double.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<double, NMPC_GUIDANCE>(const FusedArgs<double>&,
                                           cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
