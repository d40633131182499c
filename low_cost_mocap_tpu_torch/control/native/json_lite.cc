#include "json_lite.h"

#include <cstdlib>
#include <cstring>

namespace lcm {

namespace {

// Finds `"key"` followed by ':' ; returns pointer just past the colon.
const char* FindValue(const char* json, const char* key) {
  const size_t klen = std::strlen(key);
  const char* p = json;
  while ((p = std::strchr(p, '"')) != nullptr) {
    ++p;
    if (std::strncmp(p, key, klen) == 0 && p[klen] == '"') {
      const char* q = p + klen + 1;
      while (*q == ' ' || *q == '\t') ++q;
      if (*q == ':') return q + 1;
    }
    const char* close = std::strchr(p, '"');
    if (!close) return nullptr;
    p = close + 1;
  }
  return nullptr;
}

}  // namespace

bool JsonHasKey(const char* json, const char* key) {
  return FindValue(json, key) != nullptr;
}

int JsonNumberArray(const char* json, const char* key, double* out, int max_n) {
  const char* v = FindValue(json, key);
  if (!v) return -1;
  while (*v == ' ' || *v == '\t') ++v;
  if (*v != '[') return -1;
  ++v;
  int n = 0;
  while (n < max_n) {
    char* end = nullptr;
    const double x = std::strtod(v, &end);
    if (end == v) break;
    out[n++] = x;
    v = end;
    while (*v == ' ' || *v == '\t' || *v == ',') ++v;
    if (*v == ']') break;
  }
  return n;
}

bool JsonBool(const char* json, const char* key, bool* out) {
  const char* v = FindValue(json, key);
  if (!v) return false;
  while (*v == ' ' || *v == '\t') ++v;
  if (std::strncmp(v, "true", 4) == 0) {
    *out = true;
    return true;
  }
  if (std::strncmp(v, "false", 5) == 0) {
    *out = false;
    return true;
  }
  return false;
}

}  // namespace lcm
