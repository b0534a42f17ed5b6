// K2's C entry nmpc_linearize_usv_acados, on the model form
// models/usv_acados.cuh.  One translation unit per model form, so
// that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/usv_acados.cuh"

// the form's team in float and in double (linearize_lanes.cuh), chosen by
// tools/k2_compare.py's sweep (PERF.md §6)
using FloatTeam = Team<3>;
using DoubleTeam = Team<3>;
NMPC_LINEARIZE_ENTRY(usv_acados, UsvAcados, FloatTeam, DoubleTeam)
