// K1 instance (nx, nu) = (6, 2) for race_cars and
// race_cars_dev, in double.  One translation unit per instance, so
// that nvcc compiles the instances in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

template NMPC_K1_LAUNCH(double, 6, 2);

}  // namespace k1
}  // namespace nmpc
