// K3 instance for the flagship usv_guidance_ca1 (nx=8, nu=1, one control box
// row, 8 soft rows), in float.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "ipm_lanes.cuh"

namespace nmpc {
namespace ipm {

template int launch<float, NMPC_FLAGSHIP>(const FusedArgs<float>&,
                                          cudaStream_t);

}  // namespace ipm
}  // namespace nmpc
