// K2's C entry nmpc_linearize_usv_guidance5, on the model form
// models/usv_guidance5.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_guidance5.cuh"

NMPC_LINEARIZE_ENTRY(usv_guidance5, UsvGuidance5)
