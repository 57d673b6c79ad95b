/* Minimal JNI declarations for building libslimt_jni.so without a JDK.
 *
 * The JNI Native Interface is a public, versioned ABI (JNI 1.6,
 * Oracle "Java Native Interface Specification", chapter 4): JNIEnv*
 * points at a pointer to a 233-slot function table whose slot order
 * is fixed by the spec. This header declares that table with every
 * slot present BY NAME and IN SPEC ORDER, with full C types for the
 * slots the slimt binding calls — so a library compiled against it
 * is layout-compatible with a real JVM's jni.h.
 *
 * When a JDK is available, define SLIMT_JNI_USE_SYSTEM_JNI_H and the
 * real <jni.h> is used instead. The binding issues every JNI call
 * through SLIMT_JNI_CALL (bottom of this header): under this compat
 * header (and under a real jni.h compiled as C) JNIEnv is a pointer
 * to the table pointer, so the call is `(*env)->Fn(env, ...)`; under
 * a real jni.h compiled as C++, JNIEnv is the JNIEnv_ class and the
 * table hangs off its `functions` member, so the call is
 * `env->functions->Fn(env, ...)`.
 *
 * Counterpart of the reference's use of <jni.h> in
 * bindings/java/slimt.cpp:3.
 */
#ifndef SLIMT_JNI_COMPAT_H_
#define SLIMT_JNI_COMPAT_H_

#ifdef SLIMT_JNI_USE_SYSTEM_JNI_H
#include <jni.h>
#else

#include <stdarg.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* --- primitive types (jni.h / jni_md.h, LP64) --------------------- */
typedef unsigned char jboolean;
typedef int8_t jbyte;
typedef uint16_t jchar;
typedef int16_t jshort;
typedef int32_t jint;
typedef int64_t jlong;
typedef float jfloat;
typedef double jdouble;
typedef jint jsize;

#define JNI_FALSE 0
#define JNI_TRUE 1
#define JNI_OK 0
#define JNI_ERR (-1)
#define JNI_VERSION_1_6 0x00010006

/* --- reference types (opaque pointers) ---------------------------- */
typedef void* jobject;
typedef jobject jclass;
typedef jobject jstring;
typedef jobject jthrowable;
typedef jobject jweak;
typedef jobject jarray;
typedef jarray jobjectArray;
typedef jarray jbooleanArray;
typedef jarray jbyteArray;
typedef jarray jcharArray;
typedef jarray jshortArray;
typedef jarray jintArray;
typedef jarray jlongArray;
typedef jarray jfloatArray;
typedef jarray jdoubleArray;

struct _jfieldID;
typedef struct _jfieldID* jfieldID;
struct _jmethodID;
typedef struct _jmethodID* jmethodID;

typedef union jvalue {
  jboolean z;
  jbyte b;
  jchar c;
  jshort s;
  jint i;
  jlong j;
  jfloat f;
  jdouble d;
  jobject l;
} jvalue;

typedef enum jobjectRefType {
  JNIInvalidRefType = 0,
  JNILocalRefType = 1,
  JNIGlobalRefType = 2,
  JNIWeakGlobalRefType = 3
} jobjectRefType;

struct JNINativeInterface_;
typedef const struct JNINativeInterface_* JNIEnv;
struct JNIInvokeInterface_;
typedef const struct JNIInvokeInterface_* JavaVM;

typedef struct {
  char* name;
  char* signature;
  void* fnPtr;
} JNINativeMethod;

/* --- the function table, spec order (JNI 1.6) ---------------------
 * Slots the binding does not call are declared as plain `void*` —
 * every slot is a pointer, so the layout is identical; the NAME and
 * POSITION of each slot below match the spec so the offsets of the
 * typed slots are the real JVM offsets. Index comments are the
 * spec's table indices.                                             */
struct JNINativeInterface_ {
  void* reserved0; /* 0 */
  void* reserved1; /* 1 */
  void* reserved2; /* 2 */
  void* reserved3; /* 3 */

  jint(*GetVersion)(JNIEnv*); /* 4 */

  void* DefineClass; /* 5 */
  jclass(*FindClass)(JNIEnv*, const char*); /* 6 */

  void* FromReflectedMethod; /* 7 */
  void* FromReflectedField;  /* 8 */
  void* ToReflectedMethod;   /* 9 */
  void* GetSuperclass;       /* 10 */
  void* IsAssignableFrom;    /* 11 */
  void* ToReflectedField;    /* 12 */

  void* Throw; /* 13 */
  jint(*ThrowNew)(JNIEnv*, jclass, const char*); /* 14 */
  void* ExceptionOccurred; /* 15 */
  void* ExceptionDescribe; /* 16 */
  void (*ExceptionClear)(JNIEnv*); /* 17 */
  void* FatalError;     /* 18 */
  void* PushLocalFrame; /* 19 */
  void* PopLocalFrame;  /* 20 */

  void* NewGlobalRef;    /* 21 */
  void* DeleteGlobalRef; /* 22 */
  void (*DeleteLocalRef)(JNIEnv*, jobject); /* 23 */
  void* IsSameObject;        /* 24 */
  void* NewLocalRef;         /* 25 */
  void* EnsureLocalCapacity; /* 26 */

  void* AllocObject; /* 27 */
  void* NewObject;   /* 28 */
  void* NewObjectV;  /* 29 */
  void* NewObjectA;  /* 30 */

  jclass(*GetObjectClass)(JNIEnv*, jobject); /* 31 */
  void* IsInstanceOf; /* 32 */
  void* GetMethodID;  /* 33 */

  void* CallObjectMethod;   /* 34 */
  void* CallObjectMethodV;  /* 35 */
  void* CallObjectMethodA;  /* 36 */
  void* CallBooleanMethod;  /* 37 */
  void* CallBooleanMethodV; /* 38 */
  void* CallBooleanMethodA; /* 39 */
  void* CallByteMethod;     /* 40 */
  void* CallByteMethodV;    /* 41 */
  void* CallByteMethodA;    /* 42 */
  void* CallCharMethod;     /* 43 */
  void* CallCharMethodV;    /* 44 */
  void* CallCharMethodA;    /* 45 */
  void* CallShortMethod;    /* 46 */
  void* CallShortMethodV;   /* 47 */
  void* CallShortMethodA;   /* 48 */
  void* CallIntMethod;      /* 49 */
  void* CallIntMethodV;     /* 50 */
  void* CallIntMethodA;     /* 51 */
  void* CallLongMethod;     /* 52 */
  void* CallLongMethodV;    /* 53 */
  void* CallLongMethodA;    /* 54 */
  void* CallFloatMethod;    /* 55 */
  void* CallFloatMethodV;   /* 56 */
  void* CallFloatMethodA;   /* 57 */
  void* CallDoubleMethod;   /* 58 */
  void* CallDoubleMethodV;  /* 59 */
  void* CallDoubleMethodA;  /* 60 */
  void* CallVoidMethod;     /* 61 */
  void* CallVoidMethodV;    /* 62 */
  void* CallVoidMethodA;    /* 63 */

  void* CallNonvirtualObjectMethod;   /* 64 */
  void* CallNonvirtualObjectMethodV;  /* 65 */
  void* CallNonvirtualObjectMethodA;  /* 66 */
  void* CallNonvirtualBooleanMethod;  /* 67 */
  void* CallNonvirtualBooleanMethodV; /* 68 */
  void* CallNonvirtualBooleanMethodA; /* 69 */
  void* CallNonvirtualByteMethod;     /* 70 */
  void* CallNonvirtualByteMethodV;    /* 71 */
  void* CallNonvirtualByteMethodA;    /* 72 */
  void* CallNonvirtualCharMethod;     /* 73 */
  void* CallNonvirtualCharMethodV;    /* 74 */
  void* CallNonvirtualCharMethodA;    /* 75 */
  void* CallNonvirtualShortMethod;    /* 76 */
  void* CallNonvirtualShortMethodV;   /* 77 */
  void* CallNonvirtualShortMethodA;   /* 78 */
  void* CallNonvirtualIntMethod;      /* 79 */
  void* CallNonvirtualIntMethodV;     /* 80 */
  void* CallNonvirtualIntMethodA;     /* 81 */
  void* CallNonvirtualLongMethod;     /* 82 */
  void* CallNonvirtualLongMethodV;    /* 83 */
  void* CallNonvirtualLongMethodA;    /* 84 */
  void* CallNonvirtualFloatMethod;    /* 85 */
  void* CallNonvirtualFloatMethodV;   /* 86 */
  void* CallNonvirtualFloatMethodA;   /* 87 */
  void* CallNonvirtualDoubleMethod;   /* 88 */
  void* CallNonvirtualDoubleMethodV;  /* 89 */
  void* CallNonvirtualDoubleMethodA;  /* 90 */
  void* CallNonvirtualVoidMethod;     /* 91 */
  void* CallNonvirtualVoidMethodV;    /* 92 */
  void* CallNonvirtualVoidMethodA;    /* 93 */

  jfieldID(*GetFieldID)(JNIEnv*, jclass, const char*, const char*); /* 94 */

  jobject(*GetObjectField)(JNIEnv*, jobject, jfieldID); /* 95 */
  void* GetBooleanField; /* 96 */
  void* GetByteField;    /* 97 */
  void* GetCharField;    /* 98 */
  void* GetShortField;   /* 99 */
  void* GetIntField;     /* 100 */
  jlong(*GetLongField)(JNIEnv*, jobject, jfieldID); /* 101 */
  void* GetFloatField;  /* 102 */
  void* GetDoubleField; /* 103 */

  void* SetObjectField;  /* 104 */
  void* SetBooleanField; /* 105 */
  void* SetByteField;    /* 106 */
  void* SetCharField;    /* 107 */
  void* SetShortField;   /* 108 */
  void* SetIntField;     /* 109 */
  void* SetLongField;    /* 110 */
  void* SetFloatField;   /* 111 */
  void* SetDoubleField;  /* 112 */

  void* GetStaticMethodID; /* 113 */

  void* CallStaticObjectMethod;   /* 114 */
  void* CallStaticObjectMethodV;  /* 115 */
  void* CallStaticObjectMethodA;  /* 116 */
  void* CallStaticBooleanMethod;  /* 117 */
  void* CallStaticBooleanMethodV; /* 118 */
  void* CallStaticBooleanMethodA; /* 119 */
  void* CallStaticByteMethod;     /* 120 */
  void* CallStaticByteMethodV;    /* 121 */
  void* CallStaticByteMethodA;    /* 122 */
  void* CallStaticCharMethod;     /* 123 */
  void* CallStaticCharMethodV;    /* 124 */
  void* CallStaticCharMethodA;    /* 125 */
  void* CallStaticShortMethod;    /* 126 */
  void* CallStaticShortMethodV;   /* 127 */
  void* CallStaticShortMethodA;   /* 128 */
  void* CallStaticIntMethod;      /* 129 */
  void* CallStaticIntMethodV;     /* 130 */
  void* CallStaticIntMethodA;     /* 131 */
  void* CallStaticLongMethod;     /* 132 */
  void* CallStaticLongMethodV;    /* 133 */
  void* CallStaticLongMethodA;    /* 134 */
  void* CallStaticFloatMethod;    /* 135 */
  void* CallStaticFloatMethodV;   /* 136 */
  void* CallStaticFloatMethodA;   /* 137 */
  void* CallStaticDoubleMethod;   /* 138 */
  void* CallStaticDoubleMethodV;  /* 139 */
  void* CallStaticDoubleMethodA;  /* 140 */
  void* CallStaticVoidMethod;     /* 141 */
  void* CallStaticVoidMethodV;    /* 142 */
  void* CallStaticVoidMethodA;    /* 143 */

  void* GetStaticFieldID; /* 144 */

  void* GetStaticObjectField;  /* 145 */
  void* GetStaticBooleanField; /* 146 */
  void* GetStaticByteField;    /* 147 */
  void* GetStaticCharField;    /* 148 */
  void* GetStaticShortField;   /* 149 */
  void* GetStaticIntField;     /* 150 */
  void* GetStaticLongField;    /* 151 */
  void* GetStaticFloatField;   /* 152 */
  void* GetStaticDoubleField;  /* 153 */

  void* SetStaticObjectField;  /* 154 */
  void* SetStaticBooleanField; /* 155 */
  void* SetStaticByteField;    /* 156 */
  void* SetStaticCharField;    /* 157 */
  void* SetStaticShortField;   /* 158 */
  void* SetStaticIntField;     /* 159 */
  void* SetStaticLongField;    /* 160 */
  void* SetStaticFloatField;   /* 161 */
  void* SetStaticDoubleField;  /* 162 */

  void* NewString;          /* 163 */
  void* GetStringLength;    /* 164 */
  void* GetStringChars;     /* 165 */
  void* ReleaseStringChars; /* 166 */

  jstring(*NewStringUTF)(JNIEnv*, const char*); /* 167 */
  void* GetStringUTFLength; /* 168 */
  const char* (*GetStringUTFChars)(JNIEnv*, jstring, jboolean*); /* 169 */
  void (*ReleaseStringUTFChars)(JNIEnv*, jstring, const char*); /* 170 */

  jsize(*GetArrayLength)(JNIEnv*, jarray); /* 171 */

  jobjectArray(*NewObjectArray)(JNIEnv*, jsize, jclass, jobject); /* 172 */
  jobject(*GetObjectArrayElement)(JNIEnv*, jobjectArray, jsize); /* 173 */
  void (*SetObjectArrayElement)(JNIEnv*, jobjectArray, jsize,
                                jobject); /* 174 */

  void* NewBooleanArray; /* 175 */
  void* NewByteArray;    /* 176 */
  void* NewCharArray;    /* 177 */
  void* NewShortArray;   /* 178 */
  void* NewIntArray;     /* 179 */
  void* NewLongArray;    /* 180 */
  void* NewFloatArray;   /* 181 */
  void* NewDoubleArray;  /* 182 */

  void* GetBooleanArrayElements; /* 183 */
  void* GetByteArrayElements;    /* 184 */
  void* GetCharArrayElements;    /* 185 */
  void* GetShortArrayElements;   /* 186 */
  void* GetIntArrayElements;     /* 187 */
  void* GetLongArrayElements;    /* 188 */
  void* GetFloatArrayElements;   /* 189 */
  void* GetDoubleArrayElements;  /* 190 */

  void* ReleaseBooleanArrayElements; /* 191 */
  void* ReleaseByteArrayElements;    /* 192 */
  void* ReleaseCharArrayElements;    /* 193 */
  void* ReleaseShortArrayElements;   /* 194 */
  void* ReleaseIntArrayElements;     /* 195 */
  void* ReleaseLongArrayElements;    /* 196 */
  void* ReleaseFloatArrayElements;   /* 197 */
  void* ReleaseDoubleArrayElements;  /* 198 */

  void* GetBooleanArrayRegion; /* 199 */
  void* GetByteArrayRegion;    /* 200 */
  void* GetCharArrayRegion;    /* 201 */
  void* GetShortArrayRegion;   /* 202 */
  void* GetIntArrayRegion;     /* 203 */
  void* GetLongArrayRegion;    /* 204 */
  void* GetFloatArrayRegion;   /* 205 */
  void* GetDoubleArrayRegion;  /* 206 */

  void* SetBooleanArrayRegion; /* 207 */
  void* SetByteArrayRegion;    /* 208 */
  void* SetCharArrayRegion;    /* 209 */
  void* SetShortArrayRegion;   /* 210 */
  void* SetIntArrayRegion;     /* 211 */
  void* SetLongArrayRegion;    /* 212 */
  void* SetFloatArrayRegion;   /* 213 */
  void* SetDoubleArrayRegion;  /* 214 */

  void* RegisterNatives;   /* 215 */
  void* UnregisterNatives; /* 216 */
  void* MonitorEnter;      /* 217 */
  void* MonitorExit;       /* 218 */
  void* GetJavaVM;         /* 219 */

  void* GetStringRegion;    /* 220 */
  void* GetStringUTFRegion; /* 221 */

  void* GetPrimitiveArrayCritical;     /* 222 */
  void* ReleasePrimitiveArrayCritical; /* 223 */
  void* GetStringCritical;             /* 224 */
  void* ReleaseStringCritical;         /* 225 */

  void* NewWeakGlobalRef;    /* 226 */
  void* DeleteWeakGlobalRef; /* 227 */

  jboolean(*ExceptionCheck)(JNIEnv*); /* 228 */

  void* NewDirectByteBuffer;     /* 229 */
  void* GetDirectBufferAddress;  /* 230 */
  void* GetDirectBufferCapacity; /* 231 */

  void* GetObjectRefType; /* 232 */
};

struct JNIInvokeInterface_ {
  void* reserved0;
  void* reserved1;
  void* reserved2;
  void* DestroyJavaVM;
  void* AttachCurrentThread;
  void* DetachCurrentThread;
  jint(*GetEnv)(JavaVM*, void**, jint);
  void* AttachCurrentThreadAsDaemon;
};

#define JNIEXPORT __attribute__((visibility("default")))
#define JNIIMPORT
#define JNICALL

#ifdef __cplusplus
}
#endif

#endif /* SLIMT_JNI_USE_SYSTEM_JNI_H */

/* Uniform JNI call syntax across all three compilation modes (header
 * comment above). `env` is evaluated twice — pass a plain variable. */
#if defined(SLIMT_JNI_USE_SYSTEM_JNI_H) && defined(__cplusplus)
#define SLIMT_JNI_CALL(env, fn, ...) \
  ((env)->functions->fn((env), ##__VA_ARGS__))
#else
#define SLIMT_JNI_CALL(env, fn, ...) ((*(env))->fn((env), ##__VA_ARGS__))
#endif

#endif /* SLIMT_JNI_COMPAT_H_ */
