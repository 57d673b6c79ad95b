// C embedding ABI for the slimt_tpu_torch engine (PyTorch and CUDA).
//
// The reference exposes native embedding via pybind11
// (bindings/python/slimt.cpp) and JNI (bindings/java/slimt.cpp).
// This engine is Python/PyTorch, so the native embedding surface is a
// thin C ABI that hosts an embedded CPython interpreter and delegates
// to slimt_tpu_torch/capi.py. Any C, C++, JNI, or FFI host can link
// libslimt_torch_capi.so and drive the engine in-process — the same
// role the reference's JNI layer plays for Android. The entry points
// and their contract are those of the JAX package's native/slimt_capi.h;
// slimt_tpu_torch/ops/_capi_build.py builds this file.
//
// Threading: every entry point takes the GIL via PyGILState; the
// library is safe to call from any host thread after slimt_init().
// Errors: functions return 0 / nullptr and record a message
// retrievable with slimt_last_error() (thread-local).

#include <Python.h>
#include <dlfcn.h>

#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#define SLIMT_API extern "C" __attribute__((visibility("default")))

namespace {

thread_local std::string g_last_error;
PyObject* g_capi_module = nullptr;  // slimt_tpu_torch.capi, owned

void set_error(const std::string& message) { g_last_error = message; }

// Capture the pending Python exception into g_last_error.
void capture_py_error(const char* where) {
  PyObject *type = nullptr, *value = nullptr, *trace = nullptr;
  PyErr_Fetch(&type, &value, &trace);
  PyErr_NormalizeException(&type, &value, &trace);
  std::string message = std::string(where) + ": ";
  if (value != nullptr) {
    PyObject* text = PyObject_Str(value);
    if (text != nullptr) {
      const char* utf8 = PyUnicode_AsUTF8(text);
      if (utf8 != nullptr) message += utf8;
      Py_DECREF(text);
    }
  } else {
    message += "unknown python error";
  }
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(trace);
  set_error(message);
}

struct GilGuard {
  PyGILState_STATE state;
  GilGuard() : state(PyGILState_Ensure()) {}
  ~GilGuard() { PyGILState_Release(state); }
};

// Call g_capi_module.<name>(*args); returns new reference or nullptr
// (error captured). Steals nothing.
PyObject* call_capi(const char* name, PyObject* args) {
  if (g_capi_module == nullptr) {
    set_error("slimt_init() has not been called");
    return nullptr;
  }
  PyObject* function = PyObject_GetAttrString(g_capi_module, name);
  if (function == nullptr) {
    capture_py_error(name);
    return nullptr;
  }
  PyObject* result = PyObject_CallObject(function, args);
  Py_DECREF(function);
  if (result == nullptr) capture_py_error(name);
  return result;
}

PyObject* texts_to_list(const char* const* texts, int count) {
  PyObject* list = PyList_New(count);
  if (list == nullptr) return nullptr;
  for (int i = 0; i < count; ++i) {
    PyObject* item = PyUnicode_FromString(texts[i] != nullptr ? texts[i] : "");
    if (item == nullptr) {
      Py_DECREF(list);
      return nullptr;
    }
    PyList_SET_ITEM(list, i, item);  // steals
  }
  return list;
}

// Convert a Python list[str] into a malloc'd char** (caller frees via
// slimt_free_strings).
char** list_to_strings(PyObject* list, int* count_out) {
  if (!PyList_Check(list)) {
    set_error("expected list result from capi");
    return nullptr;
  }
  Py_ssize_t count = PyList_GET_SIZE(list);
  char** out = static_cast<char**>(std::calloc(count + 1, sizeof(char*)));
  if (out == nullptr) {
    set_error("out of memory");
    return nullptr;
  }
  for (Py_ssize_t i = 0; i < count; ++i) {
    Py_ssize_t size = 0;
    const char* utf8 = PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(list, i), &size);
    if (utf8 == nullptr) {
      capture_py_error("result decode");
      for (Py_ssize_t j = 0; j < i; ++j) std::free(out[j]);
      std::free(out);
      return nullptr;
    }
    out[i] = static_cast<char*>(std::malloc(size + 1));
    if (out[i] == nullptr) {
      set_error("out of memory");
      for (Py_ssize_t j = 0; j < i; ++j) std::free(out[j]);
      std::free(out);
      return nullptr;
    }
    std::memcpy(out[i], utf8, size + 1);
  }
  *count_out = static_cast<int>(count);
  return out;
}

char** translate_like(const char* function, PyObject* args) {
  GilGuard gil;
  PyObject* result = call_capi(function, args);
  Py_DECREF(args);
  if (result == nullptr) return nullptr;
  int count = 0;
  char** strings = list_to_strings(result, &count);
  Py_DECREF(result);
  return strings;
}

}  // namespace

SLIMT_API const char* slimt_last_error(void) { return g_last_error.c_str(); }

// Initialize the embedded interpreter (idempotent; safe when the host
// process already runs Python — e.g. loaded via ctypes in tests).
// extra_pythonpath may be nullptr; when set it is prepended to
// sys.path before importing slimt_tpu_torch (the
// SLIMT_TPU_TORCH_PYTHONPATH env var works too).
SLIMT_API int slimt_init(const char* extra_pythonpath) {
  // Promote the already-mapped libpython to RTLD_GLOBAL. When this
  // library is dlopened with RTLD_LOCAL — what a JVM's
  // System.loadLibrary and a default dlopen do — libpython comes in
  // as a local-visibility dependency, and C-extension modules the
  // embedded interpreter imports (numpy's .so's don't link libpython;
  // they expect its symbols to be process-global) fail to resolve.
  // Re-dlopening the exact file that provides Py_IsInitialized with
  // RTLD_NOLOAD|RTLD_GLOBAL upgrades its visibility without loading a
  // second copy — the standard embedded-Python-under-JNI fix (used by
  // jep/pyjnius). When the symbol lives in the main executable (a
  // ctypes host) the dlopen fails harmlessly: there the symbols are
  // already global.
  {
    Dl_info info;
    if (dladdr(reinterpret_cast<void*>(&Py_IsInitialized), &info) != 0 &&
        info.dli_fname != nullptr) {
      dlopen(info.dli_fname, RTLD_NOW | RTLD_GLOBAL | RTLD_NOLOAD);
    }
  }
  if (!Py_IsInitialized()) {
    // `import site` runs (platform hooks included).
    Py_InitializeEx(0);
    // Drop the GIL acquired by initialization so host threads (and
    // this one, via GilGuard) can take it uniformly.
    PyEval_SaveThread();
  }
  GilGuard gil;
  if (g_capi_module != nullptr) return 0;

  // Insert-at-0 in {env, extra} order so the explicit API argument
  // ends up FIRST on sys.path (wins over the env var).
  const char* env_path = std::getenv("SLIMT_TPU_TORCH_PYTHONPATH");
  for (const char* path : {env_path, extra_pythonpath}) {
    if (path == nullptr || path[0] == '\0') continue;
    PyObject* sys_path = PySys_GetObject("path");  // borrowed
    PyObject* entry = PyUnicode_FromString(path);
    if (sys_path != nullptr && entry != nullptr) {
      PyList_Insert(sys_path, 0, entry);
    }
    Py_XDECREF(entry);
  }

  PyObject* module = PyImport_ImportModule("slimt_tpu_torch.capi");
  if (module == nullptr) {
    capture_py_error("import slimt_tpu_torch.capi");
    return -1;
  }
  PyObject* result =
      PyObject_CallMethod(module, "init", nullptr);
  if (result == nullptr) {
    capture_py_error("capi.init");
    Py_DECREF(module);
    return -1;
  }
  Py_DECREF(result);
  g_capi_module = module;
  return 0;
}

SLIMT_API long long slimt_service_create(int workers, int cache_size) {
  GilGuard gil;
  PyObject* args = Py_BuildValue("(ii)", workers, cache_size);
  PyObject* result = call_capi("service_create", args);
  Py_XDECREF(args);
  if (result == nullptr) return 0;
  long long handle = PyLong_AsLongLong(result);
  Py_DECREF(result);
  return handle;
}

// spec_json: see slimt_tpu_torch/capi.py model_create docstring (preset
// or config fields + artifact paths — the reference JNI ncreate inputs —
// and an optional "device", "cuda" by default).
SLIMT_API long long slimt_model_create(const char* spec_json) {
  GilGuard gil;
  PyObject* args = Py_BuildValue("(s)", spec_json);
  PyObject* result = call_capi("model_create", args);
  Py_XDECREF(args);
  if (result == nullptr) return 0;
  long long handle = PyLong_AsLongLong(result);
  Py_DECREF(result);
  return handle;
}

// Returns a NULL-terminated malloc'd array of `count` translations
// (target text, or full Response JSON when as_json). Free with
// slimt_free_strings. nullptr on error.
SLIMT_API char** slimt_translate(long long service, long long model,
                                 const char* const* texts, int count,
                                 int html, int as_json) {
  GilGuard gil;
  PyObject* list = texts_to_list(texts, count);
  if (list == nullptr) {
    capture_py_error("texts");
    return nullptr;
  }
  // "O" (not "N"): on Py_BuildValue failure partway through, "N"
  // would already have stolen the list into the dying tuple and the
  // unconditional decref below would double-free it.
  PyObject* args = Py_BuildValue("(LLOii)", service, model, list,
                                 html != 0 ? 1 : 0, as_json != 0 ? 1 : 0);
  Py_DECREF(list);
  if (args == nullptr) {
    capture_py_error("args");
    return nullptr;
  }
  return translate_like("translate", args);
}

SLIMT_API char** slimt_pivot(long long service, long long first,
                             long long second, const char* const* texts,
                             int count, int html, int as_json) {
  GilGuard gil;
  PyObject* list = texts_to_list(texts, count);
  if (list == nullptr) {
    capture_py_error("texts");
    return nullptr;
  }
  PyObject* args = Py_BuildValue("(LLLOii)", service, first, second, list,
                                 html != 0 ? 1 : 0, as_json != 0 ? 1 : 0);
  Py_DECREF(list);
  if (args == nullptr) {
    capture_py_error("args");
    return nullptr;
  }
  return translate_like("pivot", args);
}

SLIMT_API void slimt_free_strings(char** strings) {
  if (strings == nullptr) return;
  for (char** cursor = strings; *cursor != nullptr; ++cursor)
    std::free(*cursor);
  std::free(strings);
}

SLIMT_API void slimt_release(long long handle) {
  GilGuard gil;
  PyObject* args = Py_BuildValue("(L)", handle);
  PyObject* result = call_capi("release", args);
  Py_XDECREF(args);
  Py_XDECREF(result);
}

// Closes all live services/models. The interpreter stays up (safe for
// repeated init/shutdown cycles and for hosts that already run Python).
SLIMT_API int slimt_shutdown(void) {
  GilGuard gil;
  PyObject* result = call_capi("shutdown", nullptr);
  if (result == nullptr) return -1;
  Py_DECREF(result);
  return 0;
}
