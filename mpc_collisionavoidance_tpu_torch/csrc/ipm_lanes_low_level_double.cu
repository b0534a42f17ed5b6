// K3 instance for usv_low_level and usv_position_control (nx=8, nu=2,
// 2 control box rows, 5 state box rows, no h rows), in double.  One
// translation unit per instance, so that nvcc compiles the instances in
// parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<double, NMPC_LOW_LEVEL>(const FusedArgs<double>&,
                                            cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
