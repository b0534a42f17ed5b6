// K3 instance for usv_guidance2 (nx=12, nu=1, one control box row,
// one state box row, no h rows), in double.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<double, NMPC_GUIDANCE2>(const FusedArgs<double>&,
                                            cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
