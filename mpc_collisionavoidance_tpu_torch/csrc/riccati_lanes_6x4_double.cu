// K1 instance (nx, nu) = (6, 4) for race_cars_dev condensed at M = 2 (a macro
// stage of the partially condensed QP), in double.  One translation unit per
// instance, so that nvcc compiles the instances in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(double, 6, 4)

}  // namespace k1
}  // namespace nmpc
