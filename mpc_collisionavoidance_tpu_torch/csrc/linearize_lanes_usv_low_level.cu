// K2's C entry nmpc_linearize_usv_low_level, on the model form
// models/usv_low_level.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_low_level.cuh"

NMPC_LINEARIZE_ENTRY(usv_low_level, UsvLowLevel)
