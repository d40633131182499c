// Jerk-limited online trajectory generation (the Ruckig role in the
// reference: computer_code/api/index.py:86-112).  Plans multi-DoF
// S-curve profiles between stop points, sampled at a fixed timestep,
// with per-DoF velocity/acceleration/jerk limits and time synchronization
// (all DoFs arrive together, paced by the slowest).
//
// Divergence from the reference (documented): the reference hands
// intermediate waypoints to Ruckig's waypoint interpolation
// (index.py:99); here intermediate waypoints default to chained
// stop-to-stop segments — slightly more conservative (zero velocity at
// each waypoint), identical limits semantics.  models/trajectory.py's
// `blend` option superposes half-limit profiles on top of this planner
// to round vias without stopping (feasible by construction).
#pragma once

namespace lcm {

// Phase durations of a rest-to-rest 1-DoF S-curve covering |d|.
struct ScurveProfile {
  double tj = 0;  // jerk phase time
  double ta = 0;  // constant-accel phase time
  double tv = 0;  // constant-velocity phase time
  double sign = 1.0;
  double total() const { return 4 * tj + 2 * ta + tv; }
};

ScurveProfile PlanScurve(double d, double vmax, double amax, double jmax);

// Position along the profile at time t (0 <= t <= total), from 0 toward d.
double ScurveEval(const ScurveProfile& p, double jmax, double t);

// Multi-DoF synchronized plan: writes setpoints[step * n_dof + dof].
// Returns the number of steps (<= max_steps).
int PlanSegment(int n_dof, const double* start, const double* end,
                const double* vmax, const double* amax, const double* jmax,
                double timestep, double* setpoints, int max_steps);

}  // namespace lcm
