// C serving ABI over the port's inference Predictor (the port's copy of
// paddle_tpu/native/serving_capi.cpp).
//
// Reference analog: paddle/fluid/inference/capi/ (PD_NewPredictor /
// PD_PredictorRun / PD_DeletePredictor): a C-callable surface so that a
// serving stack written in C can load a save_inference_model directory and
// run it. Underneath is paddle_tpu_torch.inference.Predictor (a CUDA graph
// per feed signature on the card, the eager op-by-op run on the CPU),
// embedded through the CPython C API; pybind11 is not used. When the library
// is loaded into a Python process (ctypes), the running interpreter is
// reused (the Py_IsInitialized guard), as a CPython extension would be.
//
// Contract (float32 tensors, the serving common case):
//   pd_predictor_create(model_dir, extra_sys_path) -> handle | NULL
//       the Predictor on the card; with no card NULL, and pd_last_error()
//       carries the Predictor's refusal
//   pd_predictor_create_on(model_dir, extra_sys_path, device) -> handle | NULL
//       device "cuda" (or NULL / "") for the card, "cpu" for the CPU
//   pd_predictor_num_outputs(h)
//   pd_predictor_run(h, ...)  -> 0 ok, <0 error (see pd_last_error())
//   pd_predictor_destroy(h)
//   pd_last_error() -> message of this thread's last failed call
//
// An output computed in bfloat16 comes back widened to float32 (the values
// are exact), as Predictor.run returns it.
//
// Build (paddle_tpu_torch/native/capi.py does this at first use, keyed by
// this file's digest):
//   g++ -O2 -shared -fPIC -std=c++17 serving_capi.cpp $(python3-config --includes) \
//       -o libpaddle_tpu_torch_capi.so
// and for a standalone C consumer:
//   cc main.c -lpaddle_tpu_torch_capi $(python3-config --ldflags --embed)
#include <Python.h>

#include <cstring>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

void set_error(const char* where) {
  g_last_error = where;
  if (PyErr_Occurred()) {
    PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
    PyErr_Fetch(&type, &value, &tb);
    if (value != nullptr) {
      PyObject* s = PyObject_Str(value);
      if (s != nullptr) {
        const char* msg = PyUnicode_AsUTF8(s);
        if (msg != nullptr) {
          g_last_error += ": ";
          g_last_error += msg;
        }
        Py_DECREF(s);
      }
    }
    Py_XDECREF(type);
    Py_XDECREF(value);
    Py_XDECREF(tb);
  }
}

struct Predictor {
  PyObject* obj;            // paddle_tpu_torch.inference.Predictor instance
  PyObject* np;             // numpy module
  std::vector<std::string> fetch_names;
};

// The input is aliased, not copied: np.frombuffer over the memoryview is an
// ndarray over the caller's `data`, and the reshape is a view of it. The
// caller's buffer must stay valid and unmodified until pd_predictor_run
// returns; it does not need to outlive the call (the feed dict and every
// array over it are released before the return, and Predictor.run copies
// the feed to its device before the step runs).
PyObject* np_array_from_f32(PyObject* np, const float* data, int ndim,
                            const long long* shape) {
  long long total = 1;
  for (int i = 0; i < ndim; ++i) total *= shape[i];
  PyObject* mem = PyMemoryView_FromMemory(
      reinterpret_cast<char*>(const_cast<float*>(data)),
      total * static_cast<long long>(sizeof(float)), PyBUF_READ);
  if (mem == nullptr) return nullptr;
  PyObject* flat = PyObject_CallMethod(np, "frombuffer", "Os", mem, "float32");
  Py_DECREF(mem);
  if (flat == nullptr) return nullptr;
  PyObject* shp = PyTuple_New(ndim);
  if (shp == nullptr) {
    Py_DECREF(flat);
    return nullptr;
  }
  for (int i = 0; i < ndim; ++i) {
    PyObject* dim = PyLong_FromLongLong(shape[i]);
    if (dim == nullptr) {
      Py_DECREF(flat);
      Py_DECREF(shp);
      return nullptr;
    }
    PyTuple_SET_ITEM(shp, i, dim);
  }
  PyObject* arr = PyObject_CallMethod(flat, "reshape", "O", shp);
  Py_DECREF(flat);
  Py_DECREF(shp);
  return arr;
}

// Predictor(model_dir) on the card, or Predictor(model_dir, device=device).
void* create(const char* model_dir, const char* extra_sys_path, const char* device) {
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    // Py_InitializeEx leaves the GIL held by this thread; release it so that
    // PyGILState_Ensure/Release pairs work from any thread (a C server calling
    // run() from worker threads would otherwise deadlock)
    PyEval_SaveThread();
  }
  PyGILState_STATE gil = PyGILState_Ensure();
  Predictor* p = nullptr;
  PyObject *sys = nullptr, *path = nullptr, *mod = nullptr, *cls = nullptr,
           *args = nullptr, *kwargs = nullptr, *obj = nullptr, *np = nullptr;
  do {
    if (extra_sys_path != nullptr && extra_sys_path[0] != '\0') {
      sys = PyImport_ImportModule("sys");
      if (sys == nullptr) { set_error("import sys"); break; }
      path = PyObject_GetAttrString(sys, "path");
      if (path == nullptr) { set_error("sys.path"); break; }
      PyObject* entry = PyUnicode_FromString(extra_sys_path);
      if (entry == nullptr) { set_error("sys.path entry"); break; }
      PyList_Insert(path, 0, entry);
      Py_DECREF(entry);
    }
    np = PyImport_ImportModule("numpy");
    if (np == nullptr) { set_error("import numpy"); break; }
    mod = PyImport_ImportModule("paddle_tpu_torch.inference");
    if (mod == nullptr) { set_error("import paddle_tpu_torch.inference"); break; }
    cls = PyObject_GetAttrString(mod, "Predictor");
    if (cls == nullptr) { set_error("Predictor class"); break; }
    args = Py_BuildValue("(s)", model_dir);
    if (args == nullptr) { set_error("Predictor arguments"); break; }
    if (device != nullptr && device[0] != '\0') {
      kwargs = Py_BuildValue("{s:s}", "device", device);
      if (kwargs == nullptr) { set_error("Predictor arguments"); break; }
    }
    obj = PyObject_Call(cls, args, kwargs);
    if (obj == nullptr) { set_error("Predictor(model_dir)"); break; }
    p = new Predictor{obj, np, {}};
    obj = nullptr;  // ownership moved
    np = Py_NewRef(p->np);
    // the fetch names, for pd_predictor_num_outputs
    PyObject* fetches = PyObject_GetAttrString(p->obj, "fetch_names");
    if (fetches != nullptr && PySequence_Check(fetches)) {
      Py_ssize_t n = PySequence_Size(fetches);
      for (Py_ssize_t i = 0; i < n; ++i) {
        PyObject* item = PySequence_GetItem(fetches, i);
        const char* s = item ? PyUnicode_AsUTF8(item) : nullptr;
        if (s != nullptr) p->fetch_names.emplace_back(s);
        Py_XDECREF(item);
      }
    }
    Py_XDECREF(fetches);
    PyErr_Clear();
  } while (false);
  Py_XDECREF(sys);
  Py_XDECREF(path);
  Py_XDECREF(mod);
  Py_XDECREF(cls);
  Py_XDECREF(args);
  Py_XDECREF(kwargs);
  Py_XDECREF(obj);
  Py_XDECREF(np);
  PyGILState_Release(gil);
  return p;
}

}  // namespace

extern "C" {

const char* pd_last_error() { return g_last_error.c_str(); }

void* pd_predictor_create(const char* model_dir, const char* extra_sys_path) {
  return create(model_dir, extra_sys_path, nullptr);
}

void* pd_predictor_create_on(const char* model_dir, const char* extra_sys_path,
                             const char* device) {
  return create(model_dir, extra_sys_path, device);
}

int pd_predictor_num_outputs(void* handle) {
  if (handle == nullptr) return -1;
  return static_cast<int>(static_cast<Predictor*>(handle)->fetch_names.size());
}

// Runs the model on n float32 inputs; copies output `out_index` into
// out_data (capacity out_capacity elements). Returns 0 and fills
// out_ndim/out_shape (up to 8 dims) on success; -1 python error, -2 buffer
// too small, -3 bad arguments.
int pd_predictor_run(void* handle, int n_inputs, const char** names,
                     const float** datas, const int* ndims,
                     const long long* shapes_flat, int out_index,
                     float* out_data, long long out_capacity,
                     long long* out_shape, int* out_ndim) {
  if (handle == nullptr || n_inputs < 0) { g_last_error = "bad handle"; return -3; }
  Predictor* p = static_cast<Predictor*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  int rc = -1;
  PyObject *feed = nullptr, *result = nullptr, *out = nullptr,
           *ravel = nullptr, *f32 = nullptr;
  do {
    feed = PyDict_New();
    const long long* shp = shapes_flat;
    for (int i = 0; i < n_inputs; ++i) {
      PyObject* arr = np_array_from_f32(p->np, datas[i], ndims[i], shp);
      shp += ndims[i];
      if (arr == nullptr) { set_error("building input array"); goto done; }
      PyDict_SetItemString(feed, names[i], arr);
      Py_DECREF(arr);
    }
    result = PyObject_CallMethod(p->obj, "run", "O", feed);
    if (result == nullptr) { set_error("Predictor.run"); goto done; }
    out = PySequence_GetItem(result, out_index);
    if (out == nullptr) { set_error("output index"); goto done; }
    f32 = PyObject_CallMethod(p->np, "asarray", "Os", out, "float32");
    if (f32 == nullptr) { set_error("asarray(float32)"); goto done; }
    {
      PyObject* shape_t = PyObject_GetAttrString(f32, "shape");
      Py_ssize_t nd = shape_t ? PyTuple_Size(shape_t) : -1;
      if (nd < 0 || nd > 8) { set_error("output rank"); Py_XDECREF(shape_t); goto done; }
      long long total = 1;
      for (Py_ssize_t i = 0; i < nd; ++i) {
        long long d = PyLong_AsLongLong(PyTuple_GET_ITEM(shape_t, i));
        out_shape[i] = d;
        total *= d;
      }
      *out_ndim = static_cast<int>(nd);
      Py_DECREF(shape_t);
      if (total > out_capacity) { g_last_error = "output buffer too small"; rc = -2; goto done; }
      ravel = PyObject_CallMethod(f32, "tobytes", nullptr);
      if (ravel == nullptr) { set_error("tobytes"); goto done; }
      char* buf = nullptr;
      Py_ssize_t blen = 0;
      if (PyBytes_AsStringAndSize(ravel, &buf, &blen) != 0) { set_error("bytes"); goto done; }
      memcpy(out_data, buf, static_cast<size_t>(blen));
    }
    rc = 0;
  } while (false);
done:
  Py_XDECREF(feed);
  Py_XDECREF(result);
  Py_XDECREF(out);
  Py_XDECREF(ravel);
  Py_XDECREF(f32);
  if (rc != 0 && rc != -2 && PyErr_Occurred()) PyErr_Clear();
  PyGILState_Release(gil);
  return rc;
}

void pd_predictor_destroy(void* handle) {
  if (handle == nullptr) return;
  Predictor* p = static_cast<Predictor*>(handle);
  PyGILState_STATE gil = PyGILState_Ensure();
  Py_XDECREF(p->obj);
  Py_XDECREF(p->np);
  PyGILState_Release(gil);
  delete p;
}

}  // extern "C"
