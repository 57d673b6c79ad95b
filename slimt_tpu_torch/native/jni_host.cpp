// Fake-JVM harness for the port's libslimt_torch_jni.so (a copy of the
// JAX package's native/jni_host.cpp; slimt_tpu_torch/ops/_native_build.py
// builds it into slimt_tpu_torch/build/).
//
// No JDK ships in this environment, so this host stands in for the
// JVM: it builds a real JNINativeInterface_ function table (the
// spec-ordered layout in jni_compat.h), implements the slots a JNI
// library may call — string marshalling, object fields, object
// arrays, exceptions — exactly per the JNI contract, dlopens the
// binding, resolves the Java_io_github_jerinphilip_slimt_* symbols
// by name (the same lookup a JVM performs for non-RegisterNatives
// bindings), and drives Model/Service creation + translate through
// them. Exercises the identical code path a JVM host would:
// Model.ncreate(Config, Package) -> Service.ncreate ->
// Service.ntranslate -> String[].
//
// Usage:
//   jni_host <libslimt_torch_jni.so> <package_dir> <enc> <dec> <ffn_depth>
//            <heads> <text>...
// SLIMT_JNI_DEVICE, where set, becomes the Config's "device" field (the
// card when unset; "cpu" runs on the host).
// Prints one translated line per input text; exits non-zero (with
// the thrown message on stderr) if the binding throws.

#include <dlfcn.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <set>
#include <string>
#include <vector>

#include "jni_compat.h"

namespace {

// ---- the fake object model ----------------------------------------
// Every jobject handed to the binding is a FakeValue*. Classes are
// FakeValue* too (GetObjectClass returns the object itself; field
// lookups go through the object's own maps, which is sufficient for
// the field-access pattern JNI bindings use).
struct FakeValue {
  enum Kind { kString, kObject, kArray, kClass } kind;
  std::string text;                          // kString / kClass name
  std::map<std::string, jlong> longs;        // kObject
  std::map<std::string, FakeValue*> objects; // kObject (string fields)
  std::vector<FakeValue*> elements;          // kArray
};

std::vector<std::unique_ptr<FakeValue>> g_heap;
std::string g_pending_throw;
bool g_has_pending_throw = false;

FakeValue* alloc(FakeValue::Kind kind) {
  g_heap.push_back(std::unique_ptr<FakeValue>(new FakeValue()));
  g_heap.back()->kind = kind;
  return g_heap.back().get();
}

FakeValue* make_string(const std::string& text) {
  FakeValue* value = alloc(FakeValue::kString);
  value->text = text;
  return value;
}

// jfieldID: interned "name\0signature" keys.
std::set<std::string>& field_names() {
  static std::set<std::string> names;
  return names;
}

// ---- JNI table slots ----------------------------------------------
jint fake_get_version(JNIEnv*) { return JNI_VERSION_1_6; }

jclass fake_find_class(JNIEnv*, const char* name) {
  FakeValue* cls = alloc(FakeValue::kClass);
  cls->text = name;
  return cls;
}

jint fake_throw_new(JNIEnv*, jclass cls, const char* message) {
  FakeValue* klass = static_cast<FakeValue*>(cls);
  g_pending_throw = klass->text + ": " + (message != nullptr ? message : "");
  g_has_pending_throw = true;
  return 0;
}

void fake_exception_clear(JNIEnv*) {
  g_has_pending_throw = false;
  g_pending_throw.clear();
}

jboolean fake_exception_check(JNIEnv*) {
  return g_has_pending_throw ? JNI_TRUE : JNI_FALSE;
}

void fake_delete_local_ref(JNIEnv*, jobject) {}

jclass fake_get_object_class(JNIEnv*, jobject obj) {
  return static_cast<jclass>(obj);
}

jfieldID fake_get_field_id(JNIEnv*, jclass, const char* name,
                           const char* signature) {
  // SLIMT_JNI_FAKE_FAIL_FIELD=<name>: behave like a real JVM looking
  // up a field the Java class doesn't have — pend a NoSuchFieldError
  // and return null (exercises the binding's missing-field path).
  const char* fail = std::getenv("SLIMT_JNI_FAKE_FAIL_FIELD");
  if (fail != nullptr && std::strcmp(fail, name) == 0) {
    g_pending_throw = std::string("java/lang/NoSuchFieldError: ") + name;
    g_has_pending_throw = true;
    return nullptr;
  }
  std::string key = std::string(name) + "\n" + signature;
  return reinterpret_cast<jfieldID>(
      const_cast<std::string*>(&*field_names().insert(key).first));
}

const std::string& field_key(jfieldID field) {
  return *reinterpret_cast<std::string*>(field);
}

jobject fake_get_object_field(JNIEnv*, jobject obj, jfieldID field) {
  FakeValue* value = static_cast<FakeValue*>(obj);
  std::string name = field_key(field).substr(0, field_key(field).find('\n'));
  auto it = value->objects.find(name);
  return it != value->objects.end() ? it->second : nullptr;
}

jlong fake_get_long_field(JNIEnv*, jobject obj, jfieldID field) {
  FakeValue* value = static_cast<FakeValue*>(obj);
  std::string name = field_key(field).substr(0, field_key(field).find('\n'));
  auto it = value->longs.find(name);
  return it != value->longs.end() ? it->second : 0;
}

jstring fake_new_string_utf(JNIEnv*, const char* bytes) {
  return make_string(bytes != nullptr ? bytes : "");
}

const char* fake_get_string_utf_chars(JNIEnv*, jstring str,
                                      jboolean* is_copy) {
  if (is_copy != nullptr) *is_copy = JNI_FALSE;
  return static_cast<FakeValue*>(str)->text.c_str();
}

void fake_release_string_utf_chars(JNIEnv*, jstring, const char*) {}

jsize fake_get_array_length(JNIEnv*, jarray array) {
  return static_cast<jsize>(static_cast<FakeValue*>(array)->elements.size());
}

jobjectArray fake_new_object_array(JNIEnv*, jsize length, jclass,
                                   jobject initial) {
  FakeValue* array = alloc(FakeValue::kArray);
  array->elements.assign(static_cast<size_t>(length),
                         static_cast<FakeValue*>(initial));
  return array;
}

jobject fake_get_object_array_element(JNIEnv*, jobjectArray array,
                                      jsize index) {
  return static_cast<FakeValue*>(array)->elements[
      static_cast<size_t>(index)];
}

void fake_set_object_array_element(JNIEnv*, jobjectArray array, jsize index,
                                   jobject value) {
  static_cast<FakeValue*>(array)->elements[static_cast<size_t>(index)] =
      static_cast<FakeValue*>(value);
}

JNINativeInterface_ make_table() {
  JNINativeInterface_ table;
  std::memset(&table, 0, sizeof(table));
  table.GetVersion = fake_get_version;
  table.FindClass = fake_find_class;
  table.ThrowNew = fake_throw_new;
  table.ExceptionClear = fake_exception_clear;
  table.ExceptionCheck = fake_exception_check;
  table.DeleteLocalRef = fake_delete_local_ref;
  table.GetObjectClass = fake_get_object_class;
  table.GetFieldID = fake_get_field_id;
  table.GetObjectField = fake_get_object_field;
  table.GetLongField = fake_get_long_field;
  table.NewStringUTF = fake_new_string_utf;
  table.GetStringUTFChars = fake_get_string_utf_chars;
  table.ReleaseStringUTFChars = fake_release_string_utf_chars;
  table.GetArrayLength = fake_get_array_length;
  table.NewObjectArray = fake_new_object_array;
  table.GetObjectArrayElement = fake_get_object_array_element;
  table.SetObjectArrayElement = fake_set_object_array_element;
  return table;
}

// ---- native method signatures (as a JVM would call them) ----------
typedef jlong(JNICALL* ModelNCreateFn)(JNIEnv*, jobject, jobject, jobject);
typedef void(JNICALL* ModelNDestroyFn)(JNIEnv*, jobject, jlong);
typedef jlong(JNICALL* ServiceNCreateFn)(JNIEnv*, jobject, jlong);
typedef void(JNICALL* ServiceNDestroyFn)(JNIEnv*, jobject, jlong);
typedef jobjectArray(JNICALL* ServiceNTranslateFn)(JNIEnv*, jobject, jlong,
                                                   jlong, jobjectArray,
                                                   jboolean);

int fail_if_thrown(const char* where) {
  if (!g_has_pending_throw) return 0;
  std::fprintf(stderr, "%s threw: %s\n", where, g_pending_throw.c_str());
  return 1;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 8) {
    std::fprintf(stderr,
                 "usage: %s <libslimt_jni.so> <package_dir> <enc> <dec> "
                 "<ffn_depth> <heads> <text>...\n",
                 argv[0]);
    return 2;
  }
  const char* library_path = argv[1];
  const std::string package_dir = argv[2];

  void* library = dlopen(library_path, RTLD_NOW | RTLD_LOCAL);
  if (library == nullptr) {
    std::fprintf(stderr, "dlopen failed: %s\n", dlerror());
    return 1;
  }
#define RESOLVE(var, type, name)                                      \
  type var = reinterpret_cast<type>(dlsym(library, name));            \
  if (var == nullptr) {                                               \
    std::fprintf(stderr, "missing symbol %s\n", name);                \
    return 1;                                                         \
  }
  RESOLVE(model_ncreate, ModelNCreateFn,
          "Java_io_github_jerinphilip_slimt_Model_ncreate")
  RESOLVE(model_ndestroy, ModelNDestroyFn,
          "Java_io_github_jerinphilip_slimt_Model_ndestroy")
  RESOLVE(service_ncreate, ServiceNCreateFn,
          "Java_io_github_jerinphilip_slimt_Service_ncreate")
  RESOLVE(service_ndestroy, ServiceNDestroyFn,
          "Java_io_github_jerinphilip_slimt_Service_ndestroy")
  RESOLVE(service_ntranslate, ServiceNTranslateFn,
          "Java_io_github_jerinphilip_slimt_Service_ntranslate")
#undef RESOLVE

  JNINativeInterface_ table = make_table();
  JNIEnv env = &table;

  // io.github.jerinphilip.slimt.ModelConfig
  FakeValue* config = alloc(FakeValue::kObject);
  config->longs["encoder_layers"] = std::atol(argv[3]);
  config->longs["decoder_layers"] = std::atol(argv[4]);
  config->longs["feed_forward_depth"] = std::atol(argv[5]);
  config->longs["num_heads"] = std::atol(argv[6]);
  config->objects["split_mode"] = make_string("sentence");
  if (const char* device = std::getenv("SLIMT_JNI_DEVICE")) {
    config->objects["device"] = make_string(device);
  }

  // io.github.jerinphilip.slimt.Package
  FakeValue* package = alloc(FakeValue::kObject);
  package->objects["model"] = make_string(package_dir + "/model.bin");
  package->objects["vocabulary"] = make_string(package_dir + "/vocab.spm");
  package->objects["shortlist"] = make_string(package_dir + "/shortlist.bin");
  package->objects["ssplit"] = nullptr;

  jlong model = model_ncreate(&env, nullptr, config, package);
  if (int rc = fail_if_thrown("Model.ncreate")) return rc;
  jlong service = service_ncreate(&env, nullptr, /*cache_size=*/64);
  if (int rc = fail_if_thrown("Service.ncreate")) return rc;

  FakeValue* texts = alloc(FakeValue::kArray);
  for (int i = 7; i < argc; ++i) texts->elements.push_back(make_string(argv[i]));

  jobjectArray translated =
      service_ntranslate(&env, nullptr, service, model, texts, JNI_FALSE);
  if (int rc = fail_if_thrown("Service.ntranslate")) return rc;
  if (translated == nullptr) {
    std::fprintf(stderr, "ntranslate returned null without throwing\n");
    return 1;
  }
  FakeValue* results = static_cast<FakeValue*>(translated);
  for (FakeValue* element : results->elements) {
    std::printf("%s\n", element != nullptr ? element->text.c_str() : "");
  }

  service_ndestroy(&env, nullptr, service);
  model_ndestroy(&env, nullptr, model);
  return 0;
}
