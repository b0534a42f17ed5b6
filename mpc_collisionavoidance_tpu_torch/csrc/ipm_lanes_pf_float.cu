// K3 instance for usv_pf (nx=14, nu=2, 2 control box rows, 5 state
// box rows, no h rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_PF>(const FusedArgs<float>&,
                                    cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
