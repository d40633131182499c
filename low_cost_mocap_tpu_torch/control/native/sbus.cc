#include "sbus.h"

#include <cstring>

namespace lcm {

void SbusEncode(const SbusFrame& f, uint8_t out[25]) {
  std::memset(out, 0, 25);
  out[0] = 0x0F;
  uint32_t acc = 0;
  int bits = 0;
  int byte_i = 1;
  for (int c = 0; c < 16; ++c) {
    acc |= static_cast<uint32_t>(f.ch[c] & 0x7FF) << bits;
    bits += 11;
    while (bits >= 8) {
      out[byte_i++] = static_cast<uint8_t>(acc & 0xFF);
      acc >>= 8;
      bits -= 8;
    }
  }
  uint8_t flags = 0;
  if (f.ch17) flags |= 0x01;
  if (f.ch18) flags |= 0x02;
  if (f.lost_frame) flags |= 0x04;
  if (f.failsafe) flags |= 0x08;
  out[23] = flags;
  out[24] = 0x00;
}

bool SbusDecode(const uint8_t in[25], SbusFrame* f) {
  if (in[0] != 0x0F || in[24] != 0x00) return false;
  uint32_t acc = 0;
  int bits = 0;
  int byte_i = 1;
  for (int c = 0; c < 16; ++c) {
    while (bits < 11) {
      acc |= static_cast<uint32_t>(in[byte_i++]) << bits;
      bits += 8;
    }
    f->ch[c] = static_cast<uint16_t>(acc & 0x7FF);
    acc >>= 11;
    bits -= 11;
  }
  f->ch17 = in[23] & 0x01;
  f->ch18 = in[23] & 0x02;
  f->lost_frame = in[23] & 0x04;
  f->failsafe = in[23] & 0x08;
  return true;
}

}  // namespace lcm
