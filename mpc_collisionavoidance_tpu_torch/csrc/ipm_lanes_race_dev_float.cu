// K3 instance for race_cars_dev (nx=6, nu=2, 2 control box rows, no hard
// rows, 6 soft rows: the 5 h rows and the softened state box row), in
// float.  One translation unit per instance, so that nvcc compiles the
// instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_RACE_DEV>(const FusedArgs<float>&,
                                        cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
