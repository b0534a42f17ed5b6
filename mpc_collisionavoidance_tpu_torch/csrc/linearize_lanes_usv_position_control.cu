// K2's C entry nmpc_linearize_usv_position_control, on the model form
// models/usv_position_control.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_position_control.cuh"

NMPC_LINEARIZE_ENTRY(usv_position_control, UsvPositionControl)
