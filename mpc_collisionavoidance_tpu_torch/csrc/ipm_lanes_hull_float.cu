// K3 instance for the hull usv_pf_ca (nx=14, nu=2, 2 control box rows,
// 5 state box rows, 4 hard rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_HULL>(const FusedArgs<float>&,
                                      cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
