// K1 instance (nx, nu) = (5, 2) for usv_acados, in float.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(float, 5, 2)

}  // namespace k1
}  // namespace nmpc
