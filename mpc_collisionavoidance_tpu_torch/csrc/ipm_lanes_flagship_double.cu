// K3 instance for the flagship usv_guidance_ca1 (nx=8, nu=1, one control box
// row, 8 soft rows), in double.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<double, NMPC_FLAGSHIP>(const FusedArgs<double>&,
                                           cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
