// K1 instance (nx, nu) = (8, 1) for the flagship usv_guidance_ca1, in float.
// One translation unit per instance, so that nvcc compiles the instances
// in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(float, 8, 1)

}  // namespace k1
}  // namespace nmpc
