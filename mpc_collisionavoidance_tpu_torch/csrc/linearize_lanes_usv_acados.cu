// K2's C entry nmpc_linearize_usv_acados, on the model form
// models/usv_acados.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_acados.cuh"

NMPC_LINEARIZE_ENTRY(usv_acados, UsvAcados)
