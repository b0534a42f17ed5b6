// K1 instance (nx, nu) = (6, 2) for race_cars and
// race_cars_dev, in float.  One translation unit per instance, so
// that nvcc compiles the instances in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(float, 6, 2)

}  // namespace k1
}  // namespace nmpc
