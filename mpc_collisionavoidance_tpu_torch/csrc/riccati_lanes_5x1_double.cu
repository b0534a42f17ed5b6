// K1 instance (nx, nu) = (5, 1) for usv_guidance5, in double.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

template NMPC_K1_LAUNCH(double, 5, 1);

}  // namespace k1
}  // namespace nmpc
