// Point-mass quadrotor simulator for closed-loop testing of the control
// cascade.  The reference validated its firmware only on real hardware
// (SURVEY.md §4); this model closes the loop host-side: it consumes the
// SBUS channels the cascade emits (Betaflight angle-mode abstraction:
// roll/pitch sticks ~ lateral acceleration, throttle ~ vertical thrust) and
// produces the pose/velocity the mocap pipeline would feed back.
#pragma once

#include <cstdint>

namespace lcm {

struct SimParams {
  double tilt_accel = 5.0;        // m/s^2 at full stick deflection
  // Full-throttle acceleration. The velocity PID's zero output maps to PWM
  // 992 = mid-throttle (receiver_esp32.ino:240), so a consistent airframe
  // hovers at half range: max thrust ~= 2g. Higher thrust/weight makes the
  // cascade's zero-output point a hard climb and the closed loop
  // unflyable at vision rates.
  double max_thrust_accel = 19.62; // m/s^2 at full throttle (T/W = 2)
  double yaw_rate = 3.0;          // rad/s at full yaw stick
  double drag = 0.3;              // linear drag coefficient (1/s)
  double gravity = 9.81;
  // Height of the tracked marker when the drone sits on the floor.  Matters
  // because the firmware's ground-effect clamp zeroes throttle entirely at
  // z == 0 with the default coef (receiver_esp32.ino:242-243) — real
  // takeoffs work only because the landed marker reads a few cm up.
  double ground_height = 0.07;
  // First-order actuator response (motor spool-up / attitude dynamics).
  // Instant thrust would let the vehicle punch through a 60 Hz vision loop
  // before the velocity PID can react — real quads can't.
  double actuator_tau = 0.08;  // seconds
};

class DroneSim {
 public:
  explicit DroneSim(const SimParams& p = SimParams()) : p_(p) {}

  // ch: SBUS-style channels as the cascade packs them
  // (ch[0] = -yPWM, ch[1] = xPWM, ch[2] = throttle, ch[3] = yawPWM,
  //  ch[4] = arm). dt seconds.
  void Step(const int16_t ch[16], double dt);

  void SetState(const double pos[3], const double vel[3], double yaw);
  void GetState(double pos[3], double vel[3], double* yaw) const;

 private:
  SimParams p_;
  double pos_[3] = {0, 0, 0};
  double vel_[3] = {0, 0, 0};
  double yaw_ = 0;
  // lagged actuator states: nx, ny, thr
  double act_[3] = {0, 0, 0};
};

}  // namespace lcm
