// Packed entry points of the kernels' launchers.
//
// Every launcher `int name(args..., cudaStream_t)` of this library also gets
// `int name_packed(const int64_t* slots)`: its arguments in one 8-byte slot
// each, in order (a pointer or an int as a 64-bit integer, a float in the
// slot's first four bytes). `_bags_launch.launch` (pylaunch.cu) fills the
// slots from the Python arguments and calls the packed entry, whose address
// ctypes looked up once (cuda.py). The slot types come from the launcher's
// own declaration, so the two cannot disagree.

#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>
#include <utility>

namespace bags_launch {

template <typename T>
inline T from_slot(const int64_t* slot) {
  if constexpr (std::is_pointer_v<T>) {
    return reinterpret_cast<T>(static_cast<intptr_t>(*slot));
  } else if constexpr (std::is_same_v<T, float>) {
    float f;
    memcpy(&f, slot, sizeof f);
    return f;
  } else {
    static_assert(std::is_integral_v<T>, "a launcher takes pointers, integers and floats");
    return static_cast<T>(*slot);
  }
}

template <typename... A, size_t... I>
inline int unpack(int (*fn)(A...), const int64_t* slots, std::index_sequence<I...>) {
  return fn(from_slot<A>(slots + I)...);
}

template <typename... A>
inline int call(int (*fn)(A...), const int64_t* slots) {
  return unpack(fn, slots, std::index_sequence_for<A...>{});
}

}  // namespace bags_launch

#define BAGS_PACKED(name) \
  extern "C" int name##_packed(const int64_t* slots) { return bags_launch::call(name, slots); }
