// K3 instance for usv_guidance_ca (nx=9, nu=1, one control box row,
// one state box row, 8 hard rows), in double.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<double, NMPC_GUIDANCE_CA>(const FusedArgs<double>&,
                                              cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
