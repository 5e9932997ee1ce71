// C ABI library of cxxnet_tpu_torch: embeds CPython and delegates to
// cxxnet_tpu_torch.capi (the port's copy of native/cxxnet_wrapper.cc).
//
// Role parity with the reference's wrapper/cxxnet_wrapper.cpp (which wraps
// INetTrainer behind a C ABI for the ctypes frontend); here the C side is
// the *outer* shell around the Python/PyTorch core, so any C-ABI language
// can drive the trainer on the card the way reference users drove the C++
// one. Built at first use by cxxnet_tpu_torch/capi_build.py.
//
// Threading: the embed layer initializes Python once, releases the GIL,
// and re-acquires it per call (PyGILState), so calls may come from any
// thread (serialized by the GIL, like the reference's per-handle use).

#include "cxxnet_wrapper.h"

#include <Python.h>

#include <cstdarg>
#include <cstdio>
#include <mutex>
#include <string>

namespace {

PyObject *g_capi = nullptr;          // cxxnet_tpu_torch.capi module
std::once_flag g_init_once;
thread_local std::string tls_error;  // CXNGetLastError storage
thread_local std::string tls_str;    // CXNNetEvaluate return storage

void InitPython() {
  const bool we_initialized = !Py_IsInitialized();
  if (we_initialized) {
    Py_InitializeEx(0);
  }
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *mod = PyImport_ImportModule("cxxnet_tpu_torch.capi");
  if (mod == nullptr) {
    PyErr_Print();
    std::fprintf(stderr,
                 "cxxnet_wrapper: cannot import cxxnet_tpu_torch.capi - is "
                 "the package on PYTHONPATH?\n");
  }
  g_capi = mod;  // leaked on purpose: lives for the process
  PyGILState_Release(st);
  // release the GIL acquired by Py_InitializeEx on this thread so
  // other threads (and later PyGILState_Ensure calls) can take it.
  // ONLY when this library did the initialization: in a host process
  // that already runs Python (ctypes.PyDLL / a C extension), the GIL
  // we would be releasing belongs to the CALLER.
  if (we_initialized && PyGILState_Check()) {
    PyEval_SaveThread();
  }
}

void RecordPyError() {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  tls_error = "python error";
  if (value != nullptr) {
    PyObject *s = PyObject_Str(value);
    if (s != nullptr) {
      const char *c = PyUnicode_AsUTF8(s);
      if (c != nullptr) tls_error = c;
      Py_DECREF(s);
    }
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
}

// Calls capi.<fn>(...) with a Py_BuildValue-style format producing an
// argument tuple. Returns a new reference or nullptr (error recorded).
PyObject *CallCapi(const char *fn, const char *fmt, ...) {
  std::call_once(g_init_once, InitPython);
  if (g_capi == nullptr) {
    tls_error = "cxxnet_tpu_torch.capi not importable";
    return nullptr;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject *result = nullptr;
  PyObject *func = PyObject_GetAttrString(g_capi, fn);
  if (func == nullptr) {
    RecordPyError();
  } else {
    va_list ap;
    va_start(ap, fmt);
    PyObject *args = Py_VaBuildValue(fmt, ap);
    va_end(ap);
    if (args != nullptr) {
      // Py_BuildValue yields a bare object for 1-arg formats
      PyObject *tuple = PyTuple_Check(args)
                            ? args
                            : PyTuple_Pack(1, args);
      if (tuple != args) Py_DECREF(args);
      if (tuple != nullptr) {
        result = PyObject_CallObject(func, tuple);
        Py_DECREF(tuple);
      }
    }
    if (result == nullptr) RecordPyError();
    Py_DECREF(func);
  }
  PyGILState_Release(st);
  return result;
}

int CallVoid(PyObject *r) {
  if (r == nullptr) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  Py_DECREF(r);
  PyGILState_Release(st);
  return 0;
}

int64_t CallInt(PyObject *r) {
  if (r == nullptr) return -1;
  PyGILState_STATE st = PyGILState_Ensure();
  int64_t v = PyLong_AsLongLong(r);
  Py_DECREF(r);
  PyGILState_Release(st);
  return v;
}

void *CallHandle(PyObject *r) {
  int64_t v = CallInt(r);
  return v <= 0 ? nullptr : reinterpret_cast<void *>(v);
}

uint64_t Id(void *h) { return reinterpret_cast<uint64_t>(h); }
uint64_t Addr(const void *p) { return reinterpret_cast<uint64_t>(p); }

}  // namespace

extern "C" {

const char *CXNGetLastError(void) { return tls_error.c_str(); }

CXNNetHandle CXNNetCreate(const char *device, const char *cfg) {
  return CallHandle(CallCapi("net_create", "(ss)", device, cfg));
}

int CXNNetFree(CXNNetHandle h) {
  return CallVoid(CallCapi("free", "(K)", Id(h)));
}

int CXNNetSetParam(CXNNetHandle h, const char *name, const char *val) {
  return CallVoid(CallCapi("net_set_param", "(Kss)", Id(h), name, val));
}

int CXNNetInitModel(CXNNetHandle h) {
  return CallVoid(CallCapi("net_init_model", "(K)", Id(h)));
}

int CXNNetLoadModel(CXNNetHandle h, const char *fname) {
  return CallVoid(CallCapi("net_load_model", "(Ks)", Id(h), fname));
}

int CXNNetSaveModel(CXNNetHandle h, const char *fname) {
  return CallVoid(CallCapi("net_save_model", "(Ks)", Id(h), fname));
}

int CXNNetStartRound(CXNNetHandle h, int round_counter) {
  return CallVoid(CallCapi("net_start_round", "(Ki)", Id(h),
                           round_counter));
}

int CXNNetUpdateIter(CXNNetHandle h, CXNIOHandle it) {
  return CallVoid(CallCapi("net_update_iter", "(KK)", Id(h), Id(it)));
}

int CXNNetUpdateBatch(CXNNetHandle h, const float *data,
                      const uint64_t dshape[4], const float *label,
                      uint64_t label_width) {
  return CallVoid(CallCapi(
      "net_update_batch", "(KKKKKKKK)", Id(h), Addr(data), dshape[0],
      dshape[1], dshape[2], dshape[3], Addr(label), label_width));
}

int64_t CXNNetPredictBatch(CXNNetHandle h, const float *data,
                           const uint64_t dshape[4], float *out) {
  return CallInt(CallCapi("net_predict_batch", "(KKKKKKK)", Id(h),
                          Addr(data), dshape[0], dshape[1], dshape[2],
                          dshape[3], Addr(out)));
}

int64_t CXNNetPredictIter(CXNNetHandle h, CXNIOHandle it, float *out,
                          uint64_t out_capacity) {
  return CallInt(CallCapi("net_predict_iter", "(KKKK)", Id(h), Id(it),
                          Addr(out), out_capacity));
}

int64_t CXNNetExtractBatch(CXNNetHandle h, const float *data,
                           const uint64_t dshape[4], const char *node_name,
                           float *out, uint64_t out_capacity) {
  return CallInt(CallCapi("net_extract_batch", "(KKKKKKsKK)", Id(h),
                          Addr(data), dshape[0], dshape[1], dshape[2],
                          dshape[3], node_name, Addr(out), out_capacity));
}

const char *CXNNetEvaluate(CXNNetHandle h, CXNIOHandle it,
                           const char *name) {
  PyObject *r = CallCapi("net_evaluate", "(KKs)", Id(h), Id(it), name);
  if (r == nullptr) return nullptr;
  PyGILState_STATE st = PyGILState_Ensure();
  const char *c = PyUnicode_AsUTF8(r);
  tls_str = (c != nullptr) ? c : "";
  Py_DECREF(r);
  PyGILState_Release(st);
  return tls_str.c_str();
}

int64_t CXNNetGetWeight(CXNNetHandle h, const char *layer_name,
                        const char *tag, float *out, uint64_t out_capacity,
                        uint64_t shape_out[2]) {
  return CallInt(CallCapi("net_get_weight", "(KssKKK)", Id(h), layer_name,
                          tag, Addr(out), out_capacity, Addr(shape_out)));
}

int CXNNetSetWeight(CXNNetHandle h, const float *data, uint64_t rows,
                    uint64_t cols, const char *layer_name,
                    const char *tag) {
  return CallVoid(CallCapi("net_set_weight", "(KKKKss)", Id(h), Addr(data),
                           rows, cols, layer_name, tag));
}

CXNIOHandle CXNIOCreateFromConfig(const char *cfg) {
  return CallHandle(CallCapi("io_create", "(s)", cfg));
}

int CXNIOFree(CXNIOHandle h) {
  return CallVoid(CallCapi("free", "(K)", Id(h)));
}

int CXNIONext(CXNIOHandle h) {
  return static_cast<int>(CallInt(CallCapi("io_next", "(K)", Id(h))));
}

int CXNIOBeforeFirst(CXNIOHandle h) {
  return CallVoid(CallCapi("io_before_first", "(K)", Id(h)));
}

int CXNIOGetDataShape(CXNIOHandle h, uint64_t shape_out[4]) {
  return CallVoid(CallCapi("io_get_data_shape", "(KK)", Id(h),
                           Addr(shape_out)));
}

int64_t CXNIOCopyData(CXNIOHandle h, float *out) {
  return CallInt(CallCapi("io_copy_data", "(KK)", Id(h), Addr(out)));
}

int CXNIOGetLabelShape(CXNIOHandle h, uint64_t shape_out[2]) {
  return CallVoid(CallCapi("io_get_label_shape", "(KK)", Id(h),
                           Addr(shape_out)));
}

int64_t CXNIOCopyLabel(CXNIOHandle h, float *out) {
  return CallInt(CallCapi("io_copy_label", "(KK)", Id(h), Addr(out)));
}

}  // extern "C"
