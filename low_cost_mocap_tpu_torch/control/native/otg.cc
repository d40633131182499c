#include "otg.h"

#include <algorithm>
#include <cmath>

namespace lcm {

ScurveProfile PlanScurve(double d, double vmax, double amax, double jmax) {
  ScurveProfile p;
  p.sign = d < 0 ? -1.0 : 1.0;
  d = std::fabs(d);
  if (d < 1e-12 || vmax <= 0 || amax <= 0 || jmax <= 0) return p;

  // Does the acceleration ramp reach amax before vmax?
  double tj = amax / jmax;            // time to ramp jerk-limited to amax
  double v_at_full_ramp = jmax * tj * tj;  // velocity after +J then -J ramps
  double ta;
  if (v_at_full_ramp > vmax) {
    // amax never reached: triangular acceleration profile
    tj = std::sqrt(vmax / jmax);
    ta = 0.0;
  } else {
    ta = vmax / amax - tj;            // constant-accel time to reach vmax
  }
  // distance consumed by accel + decel phases at peak velocity vp:
  // each phase lasts Ta = 2 tj + ta and covers vp * Ta / 2
  double Ta = 2 * tj + ta;
  double vp = jmax * tj * (tj + ta);  // peak velocity of this ramp
  double d_ramps = vp * Ta;
  if (d_ramps <= d) {
    p.tj = tj;
    p.ta = ta;
    p.tv = (d - d_ramps) / vp;
    return p;
  }

  // vmax not reached: shrink the ramp. Try keeping amax (ta >= 0):
  // vp = amax*(tj + ta), Ta = 2tj + ta, d = vp * Ta with tj = amax/jmax.
  // Let T = tj + ta  =>  vp = amax*T, Ta = T + tj, d = amax*T*(T + tj).
  tj = amax / jmax;
  {
    const double a = amax, b = amax * tj;  // d = a*T^2 + b*T
    const double disc = b * b + 4 * a * d;
    const double T = (-b + std::sqrt(disc)) / (2 * a);
    if (T >= tj) {  // ta = T - tj >= 0: amax is reached
      p.tj = tj;
      p.ta = T - tj;
      p.tv = 0.0;
      return p;
    }
  }
  // amax not reached either: pure jerk profile, d = 2 * j * tj^3
  p.tj = std::cbrt(d / (2.0 * jmax));
  p.ta = 0.0;
  p.tv = 0.0;
  return p;
}

double ScurveEval(const ScurveProfile& p, double jmax, double t) {
  const double tj = p.tj, ta = p.ta, tv = p.tv;
  const double T = p.total();
  if (T <= 0) return 0.0;
  t = std::clamp(t, 0.0, T);

  // piecewise integrate: phases and their jerk values
  const double phases[7] = {tj, ta, tj, tv, tj, ta, tj};
  const double jerks[7] = {jmax, 0, -jmax, 0, -jmax, 0, jmax};
  double x = 0, v = 0, a = 0;
  for (int i = 0; i < 7; ++i) {
    const double dt = std::min(t, phases[i]);
    if (dt > 0) {
      const double j = jerks[i];
      x += v * dt + 0.5 * a * dt * dt + j * dt * dt * dt / 6.0;
      v += a * dt + 0.5 * j * dt * dt;
      a += j * dt;
      t -= dt;
    }
    if (t <= 0) break;
  }
  return p.sign * x;
}

int PlanSegment(int n_dof, const double* start, const double* end,
                const double* vmax, const double* amax, const double* jmax,
                double timestep, double* setpoints, int max_steps) {
  if (n_dof <= 0 || timestep <= 0) return 0;

  // plan each DoF, find the synchronizing (slowest) duration
  double T = 0;
  ScurveProfile profs[64];
  if (n_dof > 64) return 0;
  for (int i = 0; i < n_dof; ++i) {
    profs[i] = PlanScurve(end[i] - start[i], vmax[i], amax[i], jmax[i]);
    T = std::max(T, profs[i].total());
  }
  const int n_steps = std::min(
      max_steps, static_cast<int>(std::ceil(T / timestep)) + 1);
  for (int s = 0; s < n_steps; ++s) {
    const double t = std::min(s * timestep, T);
    for (int i = 0; i < n_dof; ++i) {
      // time-scale each DoF to arrive exactly at T (slower => within limits)
      const double ti = profs[i].total() > 0
                            ? t * (profs[i].total() / T)
                            : 0.0;
      setpoints[s * n_dof + i] =
          start[i] + ScurveEval(profs[i], jmax[i], ti);
    }
  }
  // pin the final sample onto the target exactly
  for (int i = 0; i < n_dof; ++i)
    setpoints[(n_steps - 1) * n_dof + i] = end[i];
  return n_steps;
}

}  // namespace lcm
