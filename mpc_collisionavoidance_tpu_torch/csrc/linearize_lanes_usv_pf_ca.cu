// K2's C entry nmpc_linearize_usv_pf_ca, on the model form
// models/usv_pf_ca.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_pf_ca.cuh"

NMPC_LINEARIZE_ENTRY(usv_pf_ca, UsvPfCa)
