// K2's C entry nmpc_linearize_race_cars, on the straight-track form of
// models/race_cars.cuh (kappa = 0, no table).  One translation unit per
// model form, so that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/race_cars.cuh"

// the form's team in float and in double (linearize_lanes.cuh), chosen by
// tools/k2_compare.py's sweep (PERF.md §6)
using FloatTeam = Team<6>;
using DoubleTeam = Team<2>;
NMPC_LINEARIZE_ENTRY(race_cars, RaceCars<false>, FloatTeam, DoubleTeam)
