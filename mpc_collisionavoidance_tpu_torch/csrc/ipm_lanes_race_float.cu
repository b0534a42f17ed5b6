// K3 instance for race_cars (nx=6, nu=2, 2 control box rows, 1 state box
// row, 3 hard h rows and 2 soft ones), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_RACE>(const FusedArgs<float>&, cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
