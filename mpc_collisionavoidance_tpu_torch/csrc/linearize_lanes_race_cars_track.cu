// K2's C entry nmpc_linearize_race_cars_track, on the curved-track form of
// models/race_cars.cuh: its f reads the curvature table the entry takes
// (models/track.cuh).  One translation unit per model form, so that nvcc
// compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/race_cars.cuh"

NMPC_LINEARIZE_TRACK_ENTRY(race_cars_track, RaceCars<true>)
