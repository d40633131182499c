// C API for the native control runtime (ctypes boundary).
//
// Exposes: a bank of drone control cascades with the reference's
// "<index digit><json>" serial framing (computer_code/api/helpers.py:121,
// sender_esp32/sender_esp32.ino:70-88), the drone simulator, the SBUS
// codec, and the jerk-limited trajectory planner.

#include <cstdint>
#include <cstring>
#include <vector>

#include "cascade.h"
#include "otg.h"
#include "sbus.h"
#include "sim.h"

extern "C" {

// ---------------------------------------------------------------- cascade

struct LcmBank {
  std::vector<lcm::DroneCascade> drones;
};

LcmBank* lcm_bank_create(int n) {
  auto* b = new LcmBank();
  b->drones.resize(n > 0 ? n : 0);
  return b;
}

void lcm_bank_destroy(LcmBank* b) { delete b; }

// Feed one framed message: first byte = drone index digit, rest = JSON.
// (The sender dongle's exact framing, sender_esp32.ino:74-80.)
// Returns the drone index, or -1 on a malformed frame.
int lcm_bank_feed(LcmBank* b, const char* frame, int len, uint64_t now_us) {
  if (!b || len < 2) return -1;
  const int idx = frame[0] - '0';
  if (idx < 0 || idx >= static_cast<int>(b->drones.size())) return -1;
  // NUL-terminate a copy of the JSON payload
  std::vector<char> json(frame + 1, frame + len);
  json.push_back('\0');
  b->drones[idx].OnCommand(json.data(), now_us);
  return idx;
}

void lcm_bank_step(LcmBank* b, int idx, uint64_t now_us, int16_t out_ch[16]) {
  if (!b || idx < 0 || idx >= static_cast<int>(b->drones.size())) return;
  const lcm::SbusChannels ch = b->drones[idx].Step(now_us);
  std::memcpy(out_ch, ch.ch, sizeof(ch.ch));
}

int lcm_bank_armed(LcmBank* b, int idx) {
  if (!b || idx < 0 || idx >= static_cast<int>(b->drones.size())) return 0;
  return b->drones[idx].armed() ? 1 : 0;
}

void lcm_bank_pwm(LcmBank* b, int idx, double out[4]) {
  if (!b || idx < 0 || idx >= static_cast<int>(b->drones.size())) return;
  const auto& d = b->drones[idx];
  out[0] = d.x_pwm();
  out[1] = d.y_pwm();
  out[2] = d.z_pwm();
  out[3] = d.yaw_pwm();
}

// ------------------------------------------------------------------- sim

lcm::DroneSim* lcm_sim_create() { return new lcm::DroneSim(); }
void lcm_sim_destroy(lcm::DroneSim* s) { delete s; }

void lcm_sim_step(lcm::DroneSim* s, const int16_t ch[16], double dt) {
  s->Step(ch, dt);
}

void lcm_sim_set_state(lcm::DroneSim* s, const double pos[3],
                       const double vel[3], double yaw) {
  s->SetState(pos, vel, yaw);
}

void lcm_sim_get_state(lcm::DroneSim* s, double pos[3], double vel[3],
                       double* yaw) {
  s->GetState(pos, vel, yaw);
}

// ------------------------------------------------------------------ sbus

void lcm_sbus_encode(const uint16_t ch[16], int flags, uint8_t out[25]) {
  lcm::SbusFrame f;
  std::memcpy(f.ch, ch, sizeof(f.ch));
  f.ch17 = flags & 0x01;
  f.ch18 = flags & 0x02;
  f.lost_frame = flags & 0x04;
  f.failsafe = flags & 0x08;
  lcm::SbusEncode(f, out);
}

int lcm_sbus_decode(const uint8_t in[25], uint16_t ch[16], int* flags) {
  lcm::SbusFrame f;
  if (!lcm::SbusDecode(in, &f)) return 0;
  std::memcpy(ch, f.ch, sizeof(f.ch));
  *flags = (f.ch17 ? 1 : 0) | (f.ch18 ? 2 : 0) | (f.lost_frame ? 4 : 0) |
           (f.failsafe ? 8 : 0);
  return 1;
}

// ------------------------------------------------------------------- otg

int lcm_otg_plan(int n_dof, const double* start, const double* end,
                 const double* vmax, const double* amax, const double* jmax,
                 double timestep, double* setpoints, int max_steps) {
  return lcm::PlanSegment(n_dof, start, end, vmax, amax, jmax, timestep,
                          setpoints, max_steps);
}

}  // extern "C"
