#include "cascade.h"

#include <algorithm>
#include <cmath>

#include "json_lite.h"

namespace lcm {

DroneCascade::DroneCascade() = default;

void DroneCascade::OnCommand(const char* json, uint64_t now_us) {
  double v[17];
  // dispatch order mirrors OnDataRecv (receiver_esp32.ino:84-119)
  if (JsonHasKey(json, "pos") && JsonHasKey(json, "vel")) {
    if (JsonNumberArray(json, "pos", v, 4) == 4) {
      x_pos_ = v[0];
      y_pos_ = v[1];
      z_pos_ = v[2];
      yaw_pos_ = v[3];
    }
    if (JsonNumberArray(json, "vel", v, 3) == 3) {
      x_vel_ = v[0];
      y_vel_ = v[1];
      z_vel_ = v[2];
    }
  } else if (JsonHasKey(json, "armed")) {
    bool armed = false;
    if (JsonBool(json, "armed", &armed)) {
      if (armed && !armed_) time_armed_us_ = now_us;
      armed_ = armed;
    }
  } else if (JsonHasKey(json, "setpoint")) {
    if (JsonNumberArray(json, "setpoint", v, 3) == 3) {
      x_sp_ = v[0];
      y_sp_ = v[1];
      z_sp_ = v[2];
    }
  } else if (JsonHasKey(json, "pid")) {
    // 17-element vector incl. ground-effect terms
    // (receiver_esp32.ino:102-113)
    if (JsonNumberArray(json, "pid", v, 17) == 17) {
      x_pos_pid_.SetTunings(v[0], v[1], v[2]);
      y_pos_pid_.SetTunings(v[0], v[1], v[2]);
      z_pos_pid_.SetTunings(v[3], v[4], v[5]);
      yaw_pos_pid_.SetTunings(v[6], v[7], v[8]);
      x_vel_pid_.SetTunings(v[9], v[10], v[11]);
      y_vel_pid_.SetTunings(v[9], v[10], v[11]);
      z_vel_pid_.SetTunings(v[12], v[13], v[14]);
      ground_effect_coef_ = v[15];
      ground_effect_offset_ = v[16];
    }
  } else if (JsonHasKey(json, "trim")) {
    if (JsonNumberArray(json, "trim", v, 4) == 4) {
      x_trim_ = static_cast<int>(v[0]);
      y_trim_ = static_cast<int>(v[1]);
      z_trim_ = static_cast<int>(v[2]);
      yaw_trim_ = static_cast<int>(v[3]);
    }
  }
  last_ping_us_ = now_us;
}

SbusChannels DroneCascade::Step(uint64_t now_us) {
  const double dt =
      has_stepped_ ? (now_us - last_step_us_) * 1e-6 : 0.0;
  last_step_us_ = now_us;
  has_stepped_ = true;

  // 2 s ping-timeout failsafe (receiver_esp32.ino:213-215)
  if (now_us - last_ping_us_ > 2000000ull) armed_ = false;

  SbusChannels out;
  if (armed_) {
    out.ch[4] = 1800;  // arm channel high (receiver_esp32.ino:218)
  } else {
    out.ch[4] = 172;   // receiver_esp32.ino:220
    x_pos_pid_.Reset();
    y_pos_pid_.Reset();
    z_pos_pid_.Reset();
    yaw_pos_pid_.Reset();
    x_vel_pid_.Reset();
    y_vel_pid_.Reset();
    z_vel_pid_.Reset();
  }

  // outer position loop -> velocity setpoints; inner velocity loop ->
  // normalized outputs (receiver_esp32.ino:230-237)
  const double x_vel_sp = x_pos_pid_.Compute(x_pos_, x_sp_, dt);
  const double y_vel_sp = y_pos_pid_.Compute(y_pos_, y_sp_, dt);
  const double z_vel_sp = z_pos_pid_.Compute(z_pos_, z_sp_, dt);
  const double yaw_out = yaw_pos_pid_.Compute(yaw_pos_, yaw_sp_, dt);
  const double x_out = x_vel_pid_.Compute(x_vel_, x_vel_sp, dt);
  const double y_out = y_vel_pid_.Compute(y_vel_, y_vel_sp, dt);
  const double z_out = z_vel_pid_.Compute(z_vel_, z_vel_sp, dt);

  // PWM mapping (receiver_esp32.ino:238-241)
  x_pwm_ = 992 + x_out * 811 + x_trim_;
  y_pwm_ = 992 + y_out * 811 + y_trim_;
  z_pwm_ = 992 + kZGain * z_out * 811 + z_trim_;
  yaw_pwm_ = 992 + yaw_out * 811 + yaw_trim_;

  // ground-effect compensation (receiver_esp32.ino:242-243)
  const double denom = 4.0 * (z_pos_ - ground_effect_offset_);
  double ge = 1.0;
  if (denom != 0.0) {
    const double r = (2.0 * kRotorRadius) / denom;
    ge = 1.0 - ground_effect_coef_ * r * r;
  }
  z_pwm_ *= std::max(0.0, ge);

  // 100 ms post-arm throttle inhibit (receiver_esp32.ino:244)
  const bool throttle_ok =
      armed_ && (now_us - time_armed_us_ > 100000ull);
  const double z_cmd = throttle_ok ? z_pwm_ : 172.0;

  // channel packing incl. the ch[0] = -yPWM quirk (receiver_esp32.ino:245-248)
  out.ch[0] = static_cast<int16_t>(-y_pwm_);
  out.ch[1] = static_cast<int16_t>(x_pwm_);
  out.ch[2] = static_cast<int16_t>(z_cmd);
  out.ch[3] = static_cast<int16_t>(yaw_pwm_);
  return out;
}

}  // namespace lcm
