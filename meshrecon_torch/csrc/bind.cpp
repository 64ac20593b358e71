// The launch entries of the kernel library as a CPython extension module,
// _meshrecon_torch_bind: one METH_FASTCALL function an entry of the
// extern "C" block below, which Kernel.launch calls. That block is the one
// declaration of an entry outside its .cu file: kernels/_build.py's
// entry_kinds reads each entry's parameter kinds (P, I, F) from it and
// checks that MR_ENTRIES names the same entries.
//
// The host compiler builds this file against Python's headers alone (no
// PyTorch or CUDA headers), and it is linked into the same shared library
// as the kernels (csrc/*.cu), which declare the entries below. A function
// converts its arguments by the parameter types of its entry and calls it:
// a pointer (P) from None (NULL), an int, or an object with data_ptr() (a
// tensor); an int (I) from an int in int32's range; a float (F) from a float
// or an int. The stream is the last argument, a pointer. It returns the
// entry's CUDA status as an int. A wrong argument count or type raises
// TypeError, an int out of int32's range OverflowError. Against ctypes this
// drops libffi's per-call argument handling and the caller's list of
// data_ptr()s. The GIL stays held: an entry returns as soon as its kernel
// is queued.
//
// launch(fn, *args) does the rest of Kernel.launch's per-call work in the
// same call: the first argument's device against the current one, that
// device's current stream, the entry, and whether the stream is capturing,
// through three of torch's own functions that _build.py hands over once
// (set_launch_hooks), so no Python frame runs between them.
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <climits>
#include <tuple>
#include <utility>

using P = void*;
using I = int;
using F = float;

extern "C" {
int mr_raster_tiles(P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                    P);
int mr_raster_tiles2(P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                     P);
int mr_raster_setup(P, P, P, P, P, I, I, I, I, P);
int mr_raster_bin(P, P, P, P, P, P, P, I, I, I, I, I, P);
int mr_sample_shadow_frame(P, P, P, P, P, P, I, I, I, I, I, P);
int mr_warp_bilinear(P, P, P, P, I, I, I, I, I, I, I, P);
int mr_warp_bicubic(P, P, P, P, I, I, I, I, I, I, I, P);
int mr_sample_bilinear_masked(P, P, P, P, P, I, I, I, P);
int mr_hs_sweep(P, P, P, P, P, P, P, P, P, P, P, P, P, I, F, I, I, I, P);
int mr_hs_jacobi_fields(P, P, P, P, P, P, P, I, F, I, I, I, P);
int mr_hs_divide(P, P, P, I, P);
int mr_roofline_copy(P, P, I, P);
int mr_roofline_fma(P, P, I, I, P);
int mr_roofline_tiny(P, P, I, I, P);
int mr_gn_sobel(P, P, P, I, I, I, P);
int mr_gn_walk(P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I, I,
               I, F, F, F, P);
int mr_gn_exit(P, P, P, P, I, I, I, I, P);
int mr_gn_finish(P, P, P, P, P, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I,
                 I, I, I, I, I, F, F, F, F, P);
int mr_sweep_proj(P, P, P, P, P, P, P, P, I, I, I, I, I, P);
int mr_sweep_cost(P, P, P, P, P, P, P, I, I, I, I, P);
int mr_sweep_best(P, P, P, P, P, I, I, I, I, P);
int mr_normals_cols(P, P, P, I, I, I, I, I, I, P);
int mr_normals_finish(P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, I,
                      P);
}

#define MR_ENTRIES(X)                                                        \
  X(mr_raster_tiles)                                                         \
  X(mr_raster_tiles2)                                                        \
  X(mr_raster_setup)                                                         \
  X(mr_raster_bin)                                                           \
  X(mr_sample_shadow_frame)                                                  \
  X(mr_warp_bilinear)                                                        \
  X(mr_warp_bicubic)                                                         \
  X(mr_sample_bilinear_masked)                                               \
  X(mr_hs_sweep)                                                             \
  X(mr_hs_jacobi_fields)                                                     \
  X(mr_hs_divide)                                                            \
  X(mr_roofline_copy)                                                        \
  X(mr_roofline_fma)                                                         \
  X(mr_roofline_tiny)                                                        \
  X(mr_gn_sobel)                                                             \
  X(mr_gn_walk)                                                              \
  X(mr_gn_exit)                                                              \
  X(mr_gn_finish)                                                            \
  X(mr_sweep_proj)                                                           \
  X(mr_sweep_cost)                                                           \
  X(mr_sweep_best)                                                           \
  X(mr_normals_cols)                                                         \
  X(mr_normals_finish)

namespace {

PyObject* g_data_ptr = nullptr;    // the interned name "data_ptr"
PyObject* g_get_device = nullptr;  // the interned name "get_device"
// launch's hooks (set_launch_hooks): torch's C functions for the index of
// the current CUDA device, a device's current stream as a raw cudaStream_t
// and whether the current stream records into a CUDA graph
PyObject* g_current_device = nullptr;
PyObject* g_raw_stream = nullptr;
PyObject* g_capturing = nullptr;
constexpr Py_ssize_t kMaxArgs = 32;

bool refuse(const char* entry, Py_ssize_t i, const char* want,
            PyObject* got) {
  PyErr_Format(PyExc_TypeError, "%s: argument %zd must be %s, not %.200s",
               entry, i, want, Py_TYPE(got)->tp_name);
  return false;
}

bool convert(const char* entry, Py_ssize_t i, PyObject* o, P* out) {
  if (o == Py_None) {
    *out = nullptr;
    return true;
  }
  PyObject* ptr = nullptr;
  if (!PyLong_Check(o)) {  // a tensor: its data_ptr()
    ptr = PyObject_CallMethodNoArgs(o, g_data_ptr);
    if (ptr == nullptr || !PyLong_Check(ptr)) {
      Py_XDECREF(ptr);
      PyErr_Clear();
      return refuse(entry, i, "None, an int or a tensor", o);
    }
    o = ptr;
  }
  *out = PyLong_AsVoidPtr(o);
  Py_XDECREF(ptr);
  return !(*out == nullptr && PyErr_Occurred());
}

bool convert(const char* entry, Py_ssize_t i, PyObject* o, I* out) {
  const long v = PyLong_AsLong(o);  // an int, or an object with __index__
  if (v == -1 && PyErr_Occurred()) {
    if (PyErr_ExceptionMatches(PyExc_TypeError)) {
      PyErr_Clear();
      return refuse(entry, i, "an int", o);
    }
    return false;
  }
  if (v < INT_MIN || v > INT_MAX) {
    PyErr_Format(PyExc_OverflowError, "%s: argument %zd (%ld) is out of "
                 "int32's range", entry, i, v);
    return false;
  }
  *out = static_cast<int>(v);
  return true;
}

bool convert(const char* entry, Py_ssize_t i, PyObject* o, F* out) {
  const double v = PyFloat_AsDouble(o);  // a float, or an int
  if (v == -1.0 && PyErr_Occurred()) {
    if (PyErr_ExceptionMatches(PyExc_TypeError)) {
      PyErr_Clear();
      return refuse(entry, i, "a float", o);
    }
    return false;
  }
  *out = static_cast<float>(v);
  return true;
}

template <typename... A, size_t... K>
bool convert_all(const char* entry, PyObject* const* args,
                 std::tuple<A...>& out, std::index_sequence<K...>) {
  return (convert(entry, K, args[K], &std::get<K>(out)) && ...);
}

template <typename... A>
PyObject* call(const char* entry, int (*fn)(A...), PyObject* const* args,
               Py_ssize_t nargs) {
  constexpr Py_ssize_t kArgs = sizeof...(A);
  if (nargs != kArgs) {
    PyErr_Format(PyExc_TypeError, "%s takes %zd arguments (%zd given)",
                 entry, kArgs, nargs);
    return nullptr;
  }
  std::tuple<A...> values;
  if (!convert_all(entry, args, values, std::index_sequence_for<A...>{}))
    return nullptr;
  return PyLong_FromLong(std::apply(fn, values));
}

#define MR_BIND(entry)                                                      \
  PyObject* py_##entry(PyObject*, PyObject* const* args, Py_ssize_t n) {    \
    return call(#entry, entry, args, n);                                    \
  }
MR_ENTRIES(MR_BIND)
#undef MR_BIND

PyObject* set_launch_hooks(PyObject*, PyObject* const* args, Py_ssize_t n) {
  if (n != 3 || !PyCallable_Check(args[0]) || !PyCallable_Check(args[1]) ||
      !PyCallable_Check(args[2])) {
    PyErr_SetString(PyExc_TypeError, "set_launch_hooks takes three "
                    "callables: current_device(), raw_stream(index), "
                    "capturing()");
    return nullptr;
  }
  Py_XSETREF(g_current_device, Py_NewRef(args[0]));
  Py_XSETREF(g_raw_stream, Py_NewRef(args[1]));
  Py_XSETREF(g_capturing, Py_NewRef(args[2]));
  Py_RETURN_NONE;
}

// launch(fn, *args): Kernel.launch's work for a launch on the current
// device. When args[0]'s get_device() is the current device, calls fn (an
// entry function of this module) on args and that device's current stream,
// then asks whether the stream is capturing, and returns (the CUDA status,
// capturing); otherwise (a CPU tensor, another device) returns None and
// launches nothing.
PyObject* launch(PyObject*, PyObject* const* args, Py_ssize_t n) {
  if (n < 2 || n > kMaxArgs) {
    PyErr_Format(PyExc_TypeError, "launch takes an entry and 1-%zd "
                 "arguments (%zd given)", kMaxArgs - 1, n - 1);
    return nullptr;
  }
  if (g_current_device == nullptr) {
    PyErr_SetString(PyExc_RuntimeError, "launch: set_launch_hooks first");
    return nullptr;
  }
  PyObject* index = PyObject_CallMethodNoArgs(args[1], g_get_device);
  if (index == nullptr) return nullptr;
  PyObject* current = PyObject_CallNoArgs(g_current_device);
  if (current == nullptr) {
    Py_DECREF(index);
    return nullptr;
  }
  const long i = PyLong_AsLong(index), c = PyLong_AsLong(current);
  Py_DECREF(current);
  if (i < 0 || i != c) {
    Py_DECREF(index);
    if (PyErr_Occurred()) return nullptr;
    Py_RETURN_NONE;
  }
  PyObject* stream = PyObject_CallOneArg(g_raw_stream, index);
  Py_DECREF(index);
  if (stream == nullptr) return nullptr;
  PyObject* stack[kMaxArgs];
  for (Py_ssize_t k = 1; k < n; ++k) stack[k - 1] = args[k];
  stack[n - 1] = stream;
  PyObject* code = PyObject_Vectorcall(args[0], stack, n, nullptr);
  Py_DECREF(stream);
  if (code == nullptr) return nullptr;
  PyObject* capturing = PyObject_CallNoArgs(g_capturing);
  if (capturing == nullptr) {
    Py_DECREF(code);
    return nullptr;
  }
  PyObject* out = PyTuple_Pack(2, code, capturing);
  Py_DECREF(code);
  Py_DECREF(capturing);
  return out;
}

#define MR_METHOD(entry)                                                    \
  {#entry, reinterpret_cast<PyCFunction>(                                   \
               reinterpret_cast<void (*)(void)>(py_##entry)),               \
   METH_FASTCALL, nullptr},
PyMethodDef kMethods[] = {
    MR_ENTRIES(MR_METHOD)
    {"set_launch_hooks",
     reinterpret_cast<PyCFunction>(
         reinterpret_cast<void (*)(void)>(set_launch_hooks)),
     METH_FASTCALL, "Set launch's three hooks."},
    {"launch",
     reinterpret_cast<PyCFunction>(reinterpret_cast<void (*)(void)>(launch)),
     METH_FASTCALL,
     "launch(fn, *args): (status, capturing), or None off the current "
     "device."},
    {nullptr, nullptr, 0, nullptr}};
#undef MR_METHOD

PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_meshrecon_torch_bind",
                       "The launch entries of the meshrecon_torch kernels.",
                       -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__meshrecon_torch_bind() {
  if (g_data_ptr == nullptr) {
    g_data_ptr = PyUnicode_InternFromString("data_ptr");
    g_get_device = PyUnicode_InternFromString("get_device");
    if (g_data_ptr == nullptr || g_get_device == nullptr) return nullptr;
  }
  return PyModule_Create(&kModule);
}
