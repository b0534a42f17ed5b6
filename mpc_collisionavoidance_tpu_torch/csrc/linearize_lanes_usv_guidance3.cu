// K2's C entry nmpc_linearize_usv_guidance3, on the model form
// models/usv_guidance3.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_guidance3.cuh"

NMPC_LINEARIZE_ENTRY(usv_guidance3, UsvGuidance3)
