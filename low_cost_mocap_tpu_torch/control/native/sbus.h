// SBUS frame codec. The firmware transmits SBUS to the flight controller at
// 50 Hz via bolderflight/sbus (receiver_esp32.ino:21-22,250-259); this is a
// dependency-free encoder/decoder of the standard 25-byte SBUS frame:
// 0x0F header, 16 x 11-bit channels little-endian packed into 22 bytes,
// flag byte (ch17, ch18, lost-frame, failsafe), 0x00 footer.
#pragma once

#include <cstdint>

namespace lcm {

struct SbusFrame {
  uint16_t ch[16] = {0};  // 11-bit channel values (0..2047)
  bool ch17 = false;
  bool ch18 = false;
  bool lost_frame = false;
  bool failsafe = false;
};

// Encodes into out[25]. Channel values are masked to 11 bits.
void SbusEncode(const SbusFrame& f, uint8_t out[25]);

// Returns false if header/footer invalid.
bool SbusDecode(const uint8_t in[25], SbusFrame* f);

}  // namespace lcm
