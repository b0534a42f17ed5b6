// K2's C entry nmpc_linearize_race_cars, on the straight-track form of
// models/race_cars.cuh (kappa = 0, no table).  One translation unit per
// model form, so that nvcc compiles the forms in parallel.

#include "linearize_lanes.cuh"
#include "models/race_cars.cuh"

NMPC_LINEARIZE_ENTRY(race_cars, RaceCars<false>)
