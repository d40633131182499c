// On-drone control cascade, host-side native implementation.
//
// Mirrors the receiver ESP32 firmware (receiver_esp32/receiver_esp32.ino)
// with identical JSON protocol and control semantics:
//   - JSON dispatch keyed on pos/vel, armed, setpoint, pid, trim
//     (receiver_esp32.ino:84-119);
//   - 7-PID nested cascade: xyz position PIDs emit velocity setpoints, xyz
//     velocity PIDs emit normalized outputs, yaw position PID
//     (receiver_esp32.ino:53-60, 230-237);
//   - 2 s ping-timeout disarm failsafe (receiver_esp32.ino:213-215);
//   - PID state reset while disarmed (receiver_esp32.ino:220-228);
//   - PWM mapping 992 +/- 811 + trim (receiver_esp32.ino:238-241);
//   - ground-effect thrust compensation
//     1 - c*((2r)/(4(z - z0)))^2 (receiver_esp32.ino:242-243);
//   - 100 ms post-arm throttle inhibit (receiver_esp32.ino:244);
//   - SBUS channel packing incl. arm channel ch[4]=1800/172 and the
//     firmware's ch[0] = -yPWM sign quirk (receiver_esp32.ino:218-220,
//     245-248).
//
// Time is explicit (micros counter advanced by the caller), so the cascade
// is deterministic for closed-loop simulation and HIL testing.
#pragma once

#include <cstdint>

#include "pid.h"

namespace lcm {

struct SbusChannels {
  int16_t ch[16] = {0};
};

class DroneCascade {
 public:
  static constexpr double kMaxVel = 100.0;       // receiver_esp32.ino:11
  static constexpr double kRotorRadius = 0.0225; // receiver_esp32.ino:12
  static constexpr double kZGain = 0.7;          // receiver_esp32.ino:13

  DroneCascade();

  // Feed one JSON command payload (the part after the drone-index digit).
  void OnCommand(const char* json, uint64_t now_us);

  // One control-loop iteration at time now_us; dt derived internally.
  // Returns the SBUS channel set the firmware would transmit.
  SbusChannels Step(uint64_t now_us);

  bool armed() const { return armed_; }
  double x_pwm() const { return x_pwm_; }
  double y_pwm() const { return y_pwm_; }
  double z_pwm() const { return z_pwm_; }
  double yaw_pwm() const { return yaw_pwm_; }

 private:
  // measured state (fed by mocap link)
  double x_pos_ = 0, y_pos_ = 0, z_pos_ = 0, yaw_pos_ = 0;
  double x_vel_ = 0, y_vel_ = 0, z_vel_ = 0;
  // setpoints
  double x_sp_ = 0, y_sp_ = 0, z_sp_ = 0, yaw_sp_ = 0;
  // trims (receiver_esp32.ino:29)
  int x_trim_ = 0, y_trim_ = 0, z_trim_ = 0, yaw_trim_ = 0;
  // ground effect (receiver_esp32.ino:31)
  double ground_effect_coef_ = 28.0, ground_effect_offset_ = -0.035;

  bool armed_ = false;
  uint64_t time_armed_us_ = 0;
  uint64_t last_ping_us_ = 0;
  uint64_t last_step_us_ = 0;
  bool has_stepped_ = false;

  // default gains: receiver_esp32.ino:42-51
  Pid x_pos_pid_{1.0, 0.0, 0.0, -kMaxVel, kMaxVel};
  Pid y_pos_pid_{1.0, 0.0, 0.0, -kMaxVel, kMaxVel};
  Pid z_pos_pid_{1.5, 0.0, 0.0, -kMaxVel, kMaxVel};
  Pid yaw_pos_pid_{0.3, 0.1, 0.05, -1.0, 1.0};
  Pid x_vel_pid_{0.2, 0.03, 0.05, -1.0, 1.0};
  Pid y_vel_pid_{0.2, 0.03, 0.05, -1.0, 1.0};
  Pid z_vel_pid_{0.3, 0.1, 0.05, -1.0, 1.0};

  double x_pwm_ = 0, y_pwm_ = 0, z_pwm_ = 0, yaw_pwm_ = 0;
};

}  // namespace lcm
