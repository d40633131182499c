// Minimal JSON reader for the drone command protocol.  The wire payloads
// (receiver_esp32/receiver_esp32.ino:84-119) are flat objects whose values
// are number arrays or booleans: {"pos":[..],"vel":[..]}, {"armed":true},
// {"setpoint":[..]}, {"pid":[..17]}, {"trim":[..4]}.  This parser supports
// exactly that subset (flat object, keys, bools, numbers, number arrays) —
// no allocation beyond the caller's buffers, no dependencies.
#pragma once

#include <cstddef>

namespace lcm {

// Extracts up to `max_n` numbers of the array value for `key`.
// Returns the count, or -1 if the key is absent/malformed.
int JsonNumberArray(const char* json, const char* key, double* out, int max_n);

// Reads a boolean value for `key` into *out. Returns true on success.
bool JsonBool(const char* json, const char* key, bool* out);

// Returns true if `key` exists in the object.
bool JsonHasKey(const char* json, const char* key);

}  // namespace lcm
