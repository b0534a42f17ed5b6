// K3 instance for usv_low_level and usv_position_control (nx=8, nu=2,
// 2 control box rows, 5 state box rows, no h rows), in float.  One
// translation unit per instance, so that nvcc compiles the instances in
// parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_LOW_LEVEL>(const FusedArgs<float>&,
                                           cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
