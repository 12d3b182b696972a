// The Python side of a launch: module `_bags_launch`, built into the kernels'
// library, with one function,
//
//     launch(address, kinds, *args) -> CUDA error code of the launch
//
// which converts the launcher's arguments to the 8-byte slots of its packed
// entry (launch.cuh) and calls it at `address`. `kinds` holds one byte an
// argument: 'p' a pointer (an int, 0 for none), 'i' an int, 'f' a float. The
// stream is the last argument. It runs holding the GIL, as the launchers only
// queue work. One such call costs a fraction of a ctypes call that converts
// the arguments, which matters where the host's cost of a launch, not the
// kernel, sets a kernel's time (cuda.py).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr Py_ssize_t kMaxSlots = 32;

typedef int (*Packed)(const int64_t*);

PyObject* launch(PyObject*, PyObject* const* args, Py_ssize_t nargs) {
  if (nargs < 2 || !PyBytes_Check(args[1])) {
    PyErr_SetString(PyExc_TypeError, "launch(address, kinds: bytes, *args)");
    return nullptr;
  }
  const Packed fn = reinterpret_cast<Packed>(PyLong_AsVoidPtr(args[0]));
  const char* kinds = PyBytes_AS_STRING(args[1]);
  const Py_ssize_t n = nargs - 2;
  if (PyErr_Occurred()) return nullptr;
  if (fn == nullptr || n != PyBytes_GET_SIZE(args[1]) || n > kMaxSlots) {
    PyErr_Format(PyExc_TypeError, "launch: %zd arguments for %zd slots", n, PyBytes_GET_SIZE(args[1]));
    return nullptr;
  }
  int64_t slots[kMaxSlots];
  for (Py_ssize_t i = 0; i < n; ++i) {
    if (kinds[i] == 'f') {
      const float f = float(PyFloat_AsDouble(args[i + 2]));
      slots[i] = 0;
      memcpy(&slots[i], &f, sizeof f);
    } else {
      slots[i] = PyLong_AsLongLong(args[i + 2]);
    }
  }
  if (PyErr_Occurred()) return nullptr;
  return PyLong_FromLong(fn(slots));
}

PyMethodDef methods[] = {
    {"launch", reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(launch)), METH_FASTCALL,
     "launch(address, kinds, *args): call a packed launcher; returns its CUDA error code"},
    {nullptr, nullptr, 0, nullptr},
};

PyModuleDef module = {PyModuleDef_HEAD_INIT, "_bags_launch", nullptr, -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__bags_launch(void) { return PyModule_Create(&module); }
