// K1 instance (nx, nu) = (8, 2) for usv_low_level and
// usv_position_control, in double.  One translation unit per instance, so
// that nvcc compiles the instances in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(double, 8, 2)

}  // namespace k1
}  // namespace nmpc
