#include "pid.h"

namespace lcm {

namespace {
double Clamp(double v, double lo, double hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}
}  // namespace

Pid::Pid(double kp, double ki, double kd, double out_min, double out_max)
    : kp_(kp), ki_(ki), kd_(kd), out_min_(out_min), out_max_(out_max) {}

void Pid::SetTunings(double kp, double ki, double kd) {
  kp_ = kp;
  ki_ = ki;
  kd_ = kd;
}

void Pid::SetOutputLimits(double out_min, double out_max) {
  out_min_ = out_min;
  out_max_ = out_max;
  output_sum_ = Clamp(output_sum_, out_min_, out_max_);
  output_ = Clamp(output_, out_min_, out_max_);
}

void Pid::Reset() {
  // PID_v1 state reset via limit sandwiching: clamp to [0,1] then [-1,0]
  // leaves sum == output == 0 regardless of prior state; restore limits
  // afterwards (the firmware's resetPid passes them back in,
  // receiver_esp32.ino:124-128).
  const double lo = out_min_, hi = out_max_;
  SetOutputLimits(0.0, 1.0);
  SetOutputLimits(-1.0, 0.0);
  SetOutputLimits(lo, hi);
  has_last_ = false;
}

double Pid::Compute(double input, double setpoint, double dt) {
  if (dt <= 0.0) return output_;
  const double error = setpoint - input;
  output_sum_ = Clamp(output_sum_ + ki_ * error * dt, out_min_, out_max_);
  const double d_input = has_last_ ? (input - last_input_) / dt : 0.0;
  last_input_ = input;
  has_last_ = true;
  output_ = Clamp(kp_ * error + output_sum_ - kd_ * d_input, out_min_, out_max_);
  return output_;
}

}  // namespace lcm
