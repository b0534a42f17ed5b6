// K1 instance (nx, nu) = (12, 1) for usv_guidance2, in float.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

template NMPC_K1_LAUNCH(float, 12, 1);

}  // namespace k1
}  // namespace nmpc
