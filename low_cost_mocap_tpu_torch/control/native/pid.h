// PID controller with the semantics of the Arduino PID_v1 library, which the
// reference's receiver firmware builds its 7-PID cascade from
// (receiver_esp32/receiver_esp32.ino:53-60).  Re-implemented from the
// documented behaviour: proportional-on-error, integral accumulated into the
// output sum and clamped to the output limits (anti-windup), derivative on
// measurement (not on error), and the SetOutputLimits() state-clamping used
// by the firmware's resetPid() trick (receiver_esp32.ino:124-128).
//
// Timing divergence (deliberate, documented): PID_v1 ignores
// SetSampleTime(0) and silently keeps its 100 ms default, so the reference
// firmware's PIDs actually update at 10 Hz inside its 2 kHz loop
// (receiver_esp32.ino:181-187 intends "sample rate determined by main
// loop").  Here dt is explicit per Compute(dt) call — the evident intent —
// with gains interpreted per-second, which makes the cascade deterministic
// and testable in simulation.
#pragma once

namespace lcm {

class Pid {
 public:
  Pid(double kp, double ki, double kd, double out_min, double out_max);

  // One controller step. dt in seconds. Returns the new output.
  double Compute(double input, double setpoint, double dt);

  void SetTunings(double kp, double ki, double kd);
  // Clamps both the output and the integral sum into [min, max] immediately
  // (PID_v1 SetOutputLimits semantics, used for the reset trick).
  void SetOutputLimits(double out_min, double out_max);
  // The firmware's resetPid(): squash state to 0 via limit sandwiching
  // (receiver_esp32.ino:124-128).
  void Reset();

  double output() const { return output_; }

 private:
  double kp_, ki_, kd_;
  double out_min_, out_max_;
  double output_sum_ = 0.0;
  double last_input_ = 0.0;
  bool has_last_ = false;
  double output_ = 0.0;
};

}  // namespace lcm
