// K1 instance (nx, nu) = (4, 1) for usv_guidance4, in double.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(double, 4, 1)

}  // namespace k1
}  // namespace nmpc
