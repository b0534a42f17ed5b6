// K1 instance (nx, nu) = (14, 2) for the hulls usv_pf_ca and usv_pf, in float.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

template NMPC_K1_LAUNCH(float, 14, 2);

}  // namespace k1
}  // namespace nmpc
