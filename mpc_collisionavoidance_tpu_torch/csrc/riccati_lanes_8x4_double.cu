// K1 instance (nx, nu) = (8, 4) for the flagship usv_guidance_ca1 condensed at
// M = 4 (a macro stage of the partially condensed QP), in double.  One
// translation unit per instance, so that nvcc compiles the instances in
// parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(double, 8, 4)

}  // namespace k1
}  // namespace nmpc
