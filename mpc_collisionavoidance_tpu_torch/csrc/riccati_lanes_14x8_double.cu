// K1 instance (nx, nu) = (14, 8) for the hull usv_pf_ca condensed at M = 4 (a
// macro stage of the partially condensed QP), in double.  One translation unit
// per instance, so that nvcc compiles the instances in parallel.

#include "riccati_lanes.cuh"

namespace nmpc {
namespace k1 {

NMPC_K1_INSTANCE(double, 14, 8)

}  // namespace k1
}  // namespace nmpc
