// K2's C entry nmpc_linearize_race_cars_track, on the curved-track form of
// models/race_cars.cuh: its f reads the curvature table the entry takes
// (models/track.cuh).  One translation unit per model form, so that nvcc
// compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/race_cars.cuh"

// the form's team in float and in double (linearize_lanes.cuh), chosen by
// tools/k2_compare.py's sweep (PERF.md §6)
using FloatTeam = Team<8>;
using DoubleTeam = Team<8, kSharedRk4>;
NMPC_LINEARIZE_TRACK_ENTRY(race_cars_track, RaceCars<true>, FloatTeam,
                           DoubleTeam)
