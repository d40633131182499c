#include "sim.h"

#include <algorithm>
#include <cmath>

namespace lcm {

namespace {
// SBUS transports 11-bit channels: the wire masks to 0x7FF, which is also
// what makes the firmware's ch[0] = -yPWM trick work (the negative int16
// wraps to a centre-mirrored value, receiver_esp32.ino:245).  Model the
// transport faithfully: wrap first, then interpret.
uint16_t Wire(int16_t pwm) { return static_cast<uint16_t>(pwm) & 0x7FF; }

double Norm(uint16_t rx) {
  // invert the cascade's 992 +/- 811 mapping to [-1, 1]
  return std::clamp((static_cast<double>(rx) - 992.0) / 811.0, -1.0, 1.0);
}
}  // namespace

void DroneSim::Step(const int16_t ch[16], double dt) {
  const bool armed = Wire(ch[4]) > 1000;
  const double nx = Norm(Wire(ch[1]));
  // undo the firmware's negation; the 11-bit wrap leaves a constant
  // +64-count bias ((2048-992) - 992), absorbed like a trim error
  const double ny = -Norm(Wire(ch[0]));
  const double nyaw = Norm(Wire(ch[3]));
  // throttle channel: 172 (cut) .. 1811 (full)
  const double thr = std::clamp(
      (static_cast<double>(Wire(ch[2])) - 172.0) / (1811.0 - 172.0), 0.0, 1.0);

  // first-order actuator lag (motor spool-up / attitude response)
  const double alpha =
      p_.actuator_tau > 0 ? std::min(dt / p_.actuator_tau, 1.0) : 1.0;
  act_[0] += (nx - act_[0]) * alpha;
  act_[1] += (ny - act_[1]) * alpha;
  act_[2] += (thr - act_[2]) * alpha;

  double acc[3] = {0.0, 0.0, -p_.gravity};
  if (armed) {
    acc[0] += act_[0] * p_.tilt_accel;
    acc[1] += act_[1] * p_.tilt_accel;
    acc[2] += act_[2] * p_.max_thrust_accel;
    // negative response: the mocap feed reports heading NEGATED (the
    // reference's locator convention, computer_code/api/helpers.py:474), so
    // a positive yaw channel must produce negative yaw rate for the yaw
    // loop to be negative feedback end-to-end
    yaw_ -= nyaw * p_.yaw_rate * dt;
  }
  for (int i = 0; i < 3; ++i) {
    acc[i] -= p_.drag * vel_[i];
    vel_[i] += acc[i] * dt;
    pos_[i] += vel_[i] * dt;
  }
  if (pos_[2] < p_.ground_height) {  // ground (marker height when landed)
    pos_[2] = p_.ground_height;
    if (vel_[2] < 0.0) vel_[2] = 0.0;
  }
}

void DroneSim::SetState(const double pos[3], const double vel[3], double yaw) {
  for (int i = 0; i < 3; ++i) {
    pos_[i] = pos[i];
    vel_[i] = vel[i];
  }
  yaw_ = yaw;
}

void DroneSim::GetState(double pos[3], double vel[3], double* yaw) const {
  for (int i = 0; i < 3; ++i) {
    pos[i] = pos_[i];
    vel[i] = vel_[i];
  }
  *yaw = yaw_;
}

}  // namespace lcm
