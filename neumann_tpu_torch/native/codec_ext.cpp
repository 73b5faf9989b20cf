// CPython extension: native binary codec for TensorData / TensorValue.
//
// Speeds up the host durability paths that are Python-call-bound:
// WAL record encode (log_put / append_batch), WAL replay decode,
// and snapshot body encode/decode. Byte format is identical to
// neumann_tpu/store/codec.py (the pure-Python fallback) — the two
// implementations round-trip each other and the on-disk format is
// unchanged.
//
// Parity note: the reference's tensor_store uses bincode + serde in
// Rust for the same role (tensor_store/src/wal.rs, snapshot.rs); this
// is the equivalent native fast path for the Python host runtime.
//
// Built at first use by neumann_tpu/native/pycodec.py with
//   g++ -O3 -shared -fPIC -I<python-include> codec_ext.cpp -lz
// and initialised via init(TensorValue, TensorData, helpers...).
//
// Error mapping: malformed input raises ValueError; the Python
// wrappers convert to StoreError. Torn/corrupt WAL tails are NOT
// errors — decode_wal stops cleanly, matching replay semantics.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#define PY_ARRAY_UNIQUE_SYMBOL NEUMANN_CODEC_ARRAY_API
#include <numpy/arrayobject.h>

#include <stdint.h>
#include <string.h>
#include <stdlib.h>
#include <zlib.h>

// Internal dict layout (CPython 3.12) for the template-clone row
// builder: PyDict_Copy of a small all-unicode dict memcpys the entry
// table (~2x faster than presized + per-key inserts), then values are
// written straight into dk_entries. Guarded by a runtime self-check
// in init; everything falls back to PyDict_SetItem when it fails.
#if PY_VERSION_HEX >= 0x030C0000 && PY_VERSION_HEX < 0x030D0000
#define NEUMANN_DICT_INTERNALS 1
// Vendored from CPython 3.12 Include/internal/pycore_dict.h (the real
// header needs C11 atomics unavailable under C++). The layout is
// stable across 3.12.x; dict_clone_selfcheck() verifies it at runtime
// against the live interpreter before the fast path is ever taken.
struct _nc_dictkeys {
    Py_ssize_t dk_refcnt;
    uint8_t dk_log2_size;
    uint8_t dk_log2_index_bytes;
    uint8_t dk_kind;              // 0 general / 1 unicode / 2 split
    uint32_t dk_version;
    Py_ssize_t dk_usable;
    Py_ssize_t dk_nentries;
    char dk_indices[];
};
struct _nc_unicode_entry {        // PyDictUnicodeEntry
    PyObject *me_key;
    PyObject *me_value;
};
#define NC_DICT_KEYS_UNICODE 1
#define NC_DK_UNICODE_ENTRIES(dk) \
    ((_nc_unicode_entry *)(&((int8_t *)((dk)->dk_indices))[ \
        (size_t)1 << (dk)->dk_log2_index_bytes]))
#endif
static int g_dict_clone_ok = 0;  // set by init() self-check

static inline uint32_t fast_crc(const unsigned char *p, size_t n);

// ---- module state (set once by init()) --------------------------------
static PyObject *g_tv_cls;            // TensorValue class
static PyObject *g_td_cls;            // TensorData class
static PyObject *g_vec_from_bytes;    // bytes -> np.ndarray f32 (copy)
static PyObject *g_sparse_from_parts; // SparseVector class
static PyObject *g_as_f4_bytes;       // any -> bytes ("<f4" cast fallback)
static PyObject *g_sparse_parts;      // SparseVector -> (dim, pos_bytes, val_bytes)

static PyObject *s_kind, *s_value, *s_fields;       // attribute names
static PyObject *d_kind, *d_value, *d_fields;       // slot descriptors
                                                    // (NULL -> dict path)
static PyObject *k_scalar, *k_vector, *k_sparse,    // kind strings
                *k_pointer, *k_pointers;
static PyObject *s_put, *s_delete;                  // WAL op strings

// ---- instance construction (bypasses frozen-dataclass __init__) -------

static PyObject *new_instance(PyObject *cls) {
    PyTypeObject *tp = (PyTypeObject *)cls;
    return tp->tp_alloc(tp, 0);
}

// Set one attribute on a fresh instance, bypassing the (frozen)
// __setattr__: through the slot's member descriptor when the class
// uses __slots__ (descr != NULL), else via the instance dict.
static int set_attr_raw(PyObject *obj, PyObject *descr, PyObject *name,
                        PyObject *val) {
    if (descr != NULL)
        return Py_TYPE(descr)->tp_descr_set(descr, obj, val);
    PyObject *d = PyObject_GenericGetDict(obj, NULL);
    if (!d) return -1;
    int rc = PyDict_SetItem(d, name, val);
    Py_DECREF(d);
    return rc;
}

// Steals `value`. Borrows `kind`.
static PyObject *make_tv(PyObject *kind, PyObject *value) {
    if (!value) return NULL;
    PyObject *obj = new_instance(g_tv_cls);
    if (!obj) { Py_DECREF(value); return NULL; }
    int rc = set_attr_raw(obj, d_kind, s_kind, kind);
    if (rc == 0) rc = set_attr_raw(obj, d_value, s_value, value);
    Py_DECREF(value);
    if (rc != 0) { Py_DECREF(obj); return NULL; }
    return obj;
}

// Steals `fields`.
static PyObject *make_td(PyObject *fields) {
    if (!fields) return NULL;
    PyObject *obj = new_instance(g_td_cls);
    if (!obj) { Py_DECREF(fields); return NULL; }
    int rc = set_attr_raw(obj, d_fields, s_fields, fields);
    Py_DECREF(fields);
    if (rc != 0) { Py_DECREF(obj); return NULL; }
    return obj;
}

// ---- bounded reader ---------------------------------------------------

typedef struct {
    const unsigned char *p;
    Py_ssize_t len, pos;
} Rd;

static int rd_need(Rd *r, Py_ssize_t n) {
    if (n < 0 || r->pos + n > r->len) {
        PyErr_SetString(PyExc_ValueError, "truncated record");
        return 0;
    }
    return 1;
}

static int rd_u8(Rd *r, unsigned *out) {
    if (!rd_need(r, 1)) return 0;
    *out = r->p[r->pos++];
    return 1;
}

static int rd_u32(Rd *r, uint32_t *out) {
    if (!rd_need(r, 4)) return 0;
    uint32_t v;
    memcpy(&v, r->p + r->pos, 4);
    r->pos += 4;
    *out = v;  // x86/arm64 little-endian
    return 1;
}

static int rd_i64(Rd *r, int64_t *out) {
    if (!rd_need(r, 8)) return 0;
    memcpy(out, r->p + r->pos, 8);
    r->pos += 8;
    return 1;
}

static int rd_f64(Rd *r, double *out) {
    if (!rd_need(r, 8)) return 0;
    memcpy(out, r->p + r->pos, 8);
    r->pos += 8;
    return 1;
}

// length-prefixed bytes: returns pointer into the buffer (no copy)
static int rd_span(Rd *r, const char **ptr, Py_ssize_t *n) {
    uint32_t len;
    if (!rd_u32(r, &len)) return 0;
    if (!rd_need(r, (Py_ssize_t)len)) return 0;
    *ptr = (const char *)(r->p + r->pos);
    *n = (Py_ssize_t)len;
    r->pos += len;
    return 1;
}

static PyObject *rd_str(Rd *r) {
    const char *p; Py_ssize_t n;
    if (!rd_span(r, &p, &n)) return NULL;
    return PyUnicode_DecodeUTF8(p, n, NULL);
}

// ---- value / data decode ---------------------------------------------

static PyObject *decode_value_c(Rd *r) {
    unsigned tag;
    if (!rd_u8(r, &tag)) return NULL;
    switch (tag) {
    case 0:
        return make_tv(k_scalar, Py_NewRef(Py_None));
    case 1: {
        unsigned b;
        if (!rd_u8(r, &b)) return NULL;
        return make_tv(k_scalar, Py_NewRef(b ? Py_True : Py_False));
    }
    case 2: {
        int64_t v;
        if (!rd_i64(r, &v)) return NULL;
        return make_tv(k_scalar, PyLong_FromLongLong(v));
    }
    case 3: {
        double v;
        if (!rd_f64(r, &v)) return NULL;
        return make_tv(k_scalar, PyFloat_FromDouble(v));
    }
    case 4:
        return make_tv(k_scalar, rd_str(r));
    case 5: {
        const char *p; Py_ssize_t n;
        if (!rd_span(r, &p, &n)) return NULL;
        return make_tv(k_scalar, PyBytes_FromStringAndSize(p, n));
    }
    case 6: {
        const char *p; Py_ssize_t n;
        if (!rd_span(r, &p, &n)) return NULL;
        if (n % 4) {   // parity with np.frombuffer: reject ragged data
            PyErr_SetString(PyExc_ValueError,
                            "vector payload not a multiple of 4 bytes");
            return NULL;
        }
        npy_intp len = (npy_intp)(n / 4);
        PyObject *arr = PyArray_SimpleNew(1, &len, NPY_FLOAT32);
        if (!arr) return NULL;
        memcpy(PyArray_DATA((PyArrayObject *)arr), p, (size_t)len * 4);
        return make_tv(k_vector, arr);
    }
    case 7: {
        uint32_t dim;
        const char *pp, *vp; Py_ssize_t pn, vn;
        if (!rd_u32(r, &dim)) return NULL;
        if (!rd_span(r, &pp, &pn)) return NULL;
        if (!rd_span(r, &vp, &vn)) return NULL;
        if ((pn % 4) || (vn % 4)) {
            PyErr_SetString(PyExc_ValueError,
                            "sparse payload not a multiple of 4 bytes");
            return NULL;
        }
        npy_intp plen = (npy_intp)(pn / 4), vlen = (npy_intp)(vn / 4);
        PyObject *pa = PyArray_SimpleNew(1, &plen, NPY_INT32);
        PyObject *va = PyArray_SimpleNew(1, &vlen, NPY_FLOAT32);
        PyObject *sv = NULL;
        if (pa && va) {
            memcpy(PyArray_DATA((PyArrayObject *)pa), pp,
                   (size_t)plen * 4);
            memcpy(PyArray_DATA((PyArrayObject *)va), vp,
                   (size_t)vlen * 4);
            sv = PyObject_CallFunction(g_sparse_from_parts, "OOI",
                                       pa, va, (unsigned int)dim);
        }
        Py_XDECREF(pa);
        Py_XDECREF(va);
        return make_tv(k_sparse, sv);
    }
    case 8:
        return make_tv(k_pointer, rd_str(r));
    case 9: {
        uint32_t n;
        if (!rd_u32(r, &n)) return NULL;
        // each pointer needs >= 4 bytes (its length prefix)
        if ((Py_ssize_t)n > (r->len - r->pos) / 4 + 1) {
            PyErr_SetString(PyExc_ValueError, "truncated record");
            return NULL;
        }
        PyObject *lst = PyList_New((Py_ssize_t)n);
        if (!lst) return NULL;
        for (uint32_t i = 0; i < n; i++) {
            PyObject *s = rd_str(r);
            if (!s) { Py_DECREF(lst); return NULL; }
            PyList_SET_ITEM(lst, i, s);
        }
        return make_tv(k_pointers, lst);
    }
    default:
        PyErr_Format(PyExc_ValueError, "bad value tag %u", tag);
        return NULL;
    }
}

static PyObject *decode_data_c(Rd *r) {
    uint32_t n;
    if (!rd_u32(r, &n)) return NULL;
    // each field needs >= 5 bytes (name length prefix + value tag)
    if ((Py_ssize_t)n > (r->len - r->pos) / 5 + 1) {
        PyErr_SetString(PyExc_ValueError, "truncated record");
        return NULL;
    }
    PyObject *fields = PyDict_New();
    if (!fields) return NULL;
    for (uint32_t i = 0; i < n; i++) {
        PyObject *name = rd_str(r);
        if (!name) { Py_DECREF(fields); return NULL; }
        PyObject *val = decode_value_c(r);
        if (!val) { Py_DECREF(name); Py_DECREF(fields); return NULL; }
        int rc = PyDict_SetItem(fields, name, val);
        Py_DECREF(name);
        Py_DECREF(val);
        if (rc != 0) { Py_DECREF(fields); return NULL; }
    }
    return make_td(fields);
}

// decode_data(buf, pos=0) -> TensorData
static PyObject *py_decode_data(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t pos = 0;
    if (!PyArg_ParseTuple(args, "y*|n", &view, &pos)) return NULL;
    Rd r = {(const unsigned char *)view.buf, view.len, pos};
    PyObject *out = (pos >= 0 && pos <= view.len)
        ? decode_data_c(&r)
        : (PyErr_SetString(PyExc_ValueError, "bad offset"), (PyObject*)NULL);
    PyBuffer_Release(&view);
    return out;
}

// decode_wal(buf) -> list[(op:str, key:str, TensorData|None)]
// Stops cleanly at the first torn or CRC-mismatched frame; raises
// ValueError on a CRC-valid but structurally malformed record.
static PyObject *py_decode_wal(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len, pos = 0;
    PyObject *out = PyList_New(0);
    if (!out) { PyBuffer_Release(&view); return NULL; }
    while (pos + 8 <= len) {
        uint32_t flen, crc;
        memcpy(&flen, buf + pos, 4);
        memcpy(&crc, buf + pos + 4, 4);
        if ((Py_ssize_t)flen > len - pos - 8) break;      // torn tail
        const unsigned char *payload = buf + pos + 8;
        if (fast_crc(payload, flen) != crc) break;  // corrupt
        Rd r = {payload, (Py_ssize_t)flen, 0};
        unsigned op;
        PyObject *rec = NULL;
        if (!rd_u8(&r, &op)) goto fail;
        if (op == 0) {
            PyObject *key = rd_str(&r);
            if (!key) goto fail;
            PyObject *td = decode_data_c(&r);
            if (!td) { Py_DECREF(key); goto fail; }
            rec = PyTuple_Pack(3, s_put, key, td);
            Py_DECREF(key);
            Py_DECREF(td);
        } else if (op == 1) {
            PyObject *key = rd_str(&r);
            if (!key) goto fail;
            rec = PyTuple_Pack(3, s_delete, key, Py_None);
            Py_DECREF(key);
        } else {
            PyErr_Format(PyExc_ValueError, "unknown WAL op %u", op);
            goto fail;
        }
        if (!rec || PyList_Append(out, rec) != 0) {
            Py_XDECREF(rec);
            goto fail;
        }
        Py_DECREF(rec);
        pos += 8 + (Py_ssize_t)flen;
    }
    PyBuffer_Release(&view);
    return out;
fail:
    Py_DECREF(out);
    PyBuffer_Release(&view);
    return NULL;
}

// ---- WAL overlay: replay without materializing Python objects --------
//
// wal_overlay(buf) parses every frame ONCE in C++ into a hash map of
// key -> final payload span (or tombstone). No Python object is
// created per record, so replay runs at reference-class record rates
// (tensor_store wal.rs replay); records materialize lazily when the
// store first touches them (overlay_pop) — the same promote-on-read
// idea as the reference's cold tier (tensor_store/src/tiered.rs).

#include <string>
#include <unordered_map>
#include <vector>

// slicing-by-16 CRC32 (IEEE, zlib-compatible): ~2-4x zlib's rate; the
// module init self-checks it against zlib and falls back on mismatch.
static uint32_t s16_tab[16][256];
static int s16_ok = 0;

#if defined(__x86_64__)
static uint32_t crc32_pclmul(uint32_t, const unsigned char *, size_t);
static int pclmul_ok = 0;
#endif

static void s16_init(void) {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        s16_tab[0][i] = c;
    }
    for (int j = 1; j < 16; j++)
        for (uint32_t i = 0; i < 256; i++)
            s16_tab[j][i] = (s16_tab[j - 1][i] >> 8)
                ^ s16_tab[0][s16_tab[j - 1][i] & 0xffu];
    unsigned char tv[257];
    for (int i = 0; i < 257; i++) tv[i] = (unsigned char)(i * 131 + 7);
    uint32_t want = (uint32_t)crc32(0, tv, sizeof tv);
    extern uint32_t s16_crc(uint32_t, const unsigned char *, size_t);
    s16_ok = (s16_crc(0, tv, sizeof tv) == want);
#if defined(__x86_64__)
    if (__builtin_cpu_supports("pclmul")
        && __builtin_cpu_supports("sse4.1")) {
        pclmul_ok = (crc32_pclmul(0, tv, sizeof tv) == want);
        // the small-size single-fold entry has its own reduction path:
        // self-check every length class incl. chained init values
        for (size_t ln = 16; pclmul_ok && ln < 80; ln += 7)
            pclmul_ok = (crc32_pclmul(0, tv, ln)
                         == (uint32_t)crc32(0, tv, ln))
                && (crc32_pclmul(0x12345678u, tv, ln)
                    == (uint32_t)crc32(0x12345678u, tv, ln));
    }
#endif
}

uint32_t s16_crc(uint32_t init, const unsigned char *p, size_t n) {
    uint32_t c = init ^ 0xFFFFFFFFu;
    while (n >= 16) {
        uint32_t a, b, d, e;
        memcpy(&a, p, 4); memcpy(&b, p + 4, 4);
        memcpy(&d, p + 8, 4); memcpy(&e, p + 12, 4);
        a ^= c;
        c = s16_tab[15][a & 0xff] ^ s16_tab[14][(a >> 8) & 0xff]
          ^ s16_tab[13][(a >> 16) & 0xff] ^ s16_tab[12][a >> 24]
          ^ s16_tab[11][b & 0xff] ^ s16_tab[10][(b >> 8) & 0xff]
          ^ s16_tab[9][(b >> 16) & 0xff] ^ s16_tab[8][b >> 24]
          ^ s16_tab[7][d & 0xff] ^ s16_tab[6][(d >> 8) & 0xff]
          ^ s16_tab[5][(d >> 16) & 0xff] ^ s16_tab[4][d >> 24]
          ^ s16_tab[3][e & 0xff] ^ s16_tab[2][(e >> 8) & 0xff]
          ^ s16_tab[1][(e >> 16) & 0xff] ^ s16_tab[0][e >> 24];
        p += 16; n -= 16;
    }
    while (n--)
        c = s16_tab[0][(c ^ *p++) & 0xff] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

#if defined(__x86_64__)
#include <immintrin.h>
__attribute__((target("pclmul,sse4.1")))
static uint32_t crc32_pclmul(uint32_t crc0, const unsigned char *buf, size_t len) {
    // Reflected CRC-32 (IEEE 802.3, zlib-compatible) via PCLMULQDQ
    // folding. Constants from the Intel "Fast CRC Computation" paper.
    static const uint64_t k1 = 0x0154442bd4ULL; // x^(4*128+32) mod P
    static const uint64_t k2 = 0x01c6e41596ULL; // x^(4*128-32) mod P
    static const uint64_t k3 = 0x01751997d0ULL; // x^(128+32) mod P
    static const uint64_t k4 = 0x00ccaa009eULL; // x^(128-32) mod P
    static const uint64_t k5 = 0x0163cd6124ULL; // x^64 mod P
    static const uint64_t poly = 0x01db710641ULL;
    static const uint64_t mu   = 0x01f7011641ULL;
    // single-xmm entry for 16..63 bytes: small WAL payloads (~40B
    // records) otherwise fall to the table CRC, which is the largest
    // per-record cost of small-log replay
    if (len < 16) return (uint32_t)crc32(crc0, buf, len);
    const __m128i K34s = _mm_set_epi64x((long long)k4, (long long)k3);
    if (len < 64) {
        uint32_t c = ~crc0;
        __m128i x = _mm_xor_si128(_mm_loadu_si128((const __m128i*)buf),
                                  _mm_cvtsi32_si128((int)c));
        buf += 16; len -= 16;
        while (len >= 16) {
            __m128i y = _mm_loadu_si128((const __m128i*)buf);
            x = _mm_xor_si128(_mm_xor_si128(
                    _mm_clmulepi64_si128(x, K34s, 0x00),
                    _mm_clmulepi64_si128(x, K34s, 0x11)), y);
            buf += 16; len -= 16;
        }
        __m128i t = _mm_clmulepi64_si128(x, K34s, 0x10);
        x = _mm_xor_si128(_mm_srli_si128(x, 8), t);
        const __m128i K5s = _mm_set_epi64x(0, (long long)k5);
        t = _mm_clmulepi64_si128(
            _mm_and_si128(x, _mm_set_epi32(0, 0, 0, -1)), K5s, 0x00);
        x = _mm_xor_si128(_mm_srli_si128(x, 4), t);
        const __m128i Kmps = _mm_set_epi64x((long long)poly,
                                            (long long)mu);
        t = _mm_clmulepi64_si128(
            _mm_and_si128(x, _mm_set_epi32(0, 0, 0, -1)), Kmps, 0x00);
        t = _mm_clmulepi64_si128(
            _mm_and_si128(t, _mm_set_epi32(0, 0, 0, -1)), Kmps, 0x10);
        x = _mm_xor_si128(x, t);
        c = (uint32_t)_mm_extract_epi32(x, 1);
        c = ~c;
        if (len) c = (uint32_t)crc32(c, buf, len);
        return c;
    }
    uint32_t c = ~crc0;
    __m128i x0 = _mm_loadu_si128((const __m128i*)buf);
    __m128i x1 = _mm_loadu_si128((const __m128i*)(buf+16));
    __m128i x2 = _mm_loadu_si128((const __m128i*)(buf+32));
    __m128i x3 = _mm_loadu_si128((const __m128i*)(buf+48));
    x0 = _mm_xor_si128(x0, _mm_cvtsi32_si128((int)c));
    buf += 64; len -= 64;
    const __m128i K12 = _mm_set_epi64x((long long)k2, (long long)k1);
    while (len >= 64) {
        __m128i y0 = _mm_loadu_si128((const __m128i*)buf);
        __m128i y1 = _mm_loadu_si128((const __m128i*)(buf+16));
        __m128i y2 = _mm_loadu_si128((const __m128i*)(buf+32));
        __m128i y3 = _mm_loadu_si128((const __m128i*)(buf+48));
        x0 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x0, K12, 0x00),
                 _mm_clmulepi64_si128(x0, K12, 0x11)), y0);
        x1 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x1, K12, 0x00),
                 _mm_clmulepi64_si128(x1, K12, 0x11)), y1);
        x2 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x2, K12, 0x00),
                 _mm_clmulepi64_si128(x2, K12, 0x11)), y2);
        x3 = _mm_xor_si128(_mm_xor_si128(
                 _mm_clmulepi64_si128(x3, K12, 0x00),
                 _mm_clmulepi64_si128(x3, K12, 0x11)), y3);
        buf += 64; len -= 64;
    }
    const __m128i K34 = _mm_set_epi64x((long long)k4, (long long)k3);
    __m128i x = _mm_xor_si128(_mm_xor_si128(
                    _mm_clmulepi64_si128(x0, K34, 0x00),
                    _mm_clmulepi64_si128(x0, K34, 0x11)), x1);
    x = _mm_xor_si128(_mm_xor_si128(
            _mm_clmulepi64_si128(x, K34, 0x00),
            _mm_clmulepi64_si128(x, K34, 0x11)), x2);
    x = _mm_xor_si128(_mm_xor_si128(
            _mm_clmulepi64_si128(x, K34, 0x00),
            _mm_clmulepi64_si128(x, K34, 0x11)), x3);
    while (len >= 16) {
        __m128i y = _mm_loadu_si128((const __m128i*)buf);
        x = _mm_xor_si128(_mm_xor_si128(
                _mm_clmulepi64_si128(x, K34, 0x00),
                _mm_clmulepi64_si128(x, K34, 0x11)), y);
        buf += 16; len -= 16;
    }
    // fold 128 -> 64 bits
    __m128i t = _mm_clmulepi64_si128(x, K34, 0x10);
    x = _mm_xor_si128(_mm_srli_si128(x, 8), t);
    const __m128i K5 = _mm_set_epi64x(0, (long long)k5);
    t = _mm_clmulepi64_si128(_mm_and_si128(x, _mm_set_epi32(0,0,0,-1)), K5, 0x00);
    x = _mm_xor_si128(_mm_srli_si128(x, 4), t);
    // Barrett reduction 64 -> 32
    const __m128i Kmp = _mm_set_epi64x((long long)poly, (long long)mu);
    t = _mm_clmulepi64_si128(_mm_and_si128(x, _mm_set_epi32(0,0,0,-1)), Kmp, 0x00);
    t = _mm_clmulepi64_si128(_mm_and_si128(t, _mm_set_epi32(0,0,0,-1)), Kmp, 0x10);
    x = _mm_xor_si128(x, t);
    c = (uint32_t)_mm_extract_epi32(x, 1);
    c = ~c;
    if (len) c = (uint32_t)crc32(c, buf, len);
    return c;
}

#endif

static inline uint32_t fast_crc(const unsigned char *p, size_t n) {
#if defined(__x86_64__)
    if (pclmul_ok && n >= 16) return crc32_pclmul(0, p, n);
#endif
    return s16_ok ? s16_crc(0, p, n) : (uint32_t)crc32(0, p, n);
}

// Open-addressing table specialized for WAL replay. Keys are
// (offset, len) views into the retained WAL buffer; values are the
// payload offset of the record body, or -1 for a delete. One flat
// calloc'd array — std::unordered_map's per-node malloc dominated the
// replay profile (measured 3.2M -> 6M+ rec/s from this change alone).
struct OvEntry {
    uint32_t hash;            // 0 = empty slot, 1 = erased slot
    uint32_t klen;
    uint64_t koff;            // key offset in buf
    Py_ssize_t val;           // payload offset, or -1 tombstone
    uint32_t flen;            // frame payload length (lazy-CRC check)
};

struct WalOverlay {
    PyObject *buf;            // owned ref to the WAL buffer object
    Py_buffer view;           // held for the overlay's lifetime
    Py_ssize_t blen;
    const char *base;
    OvEntry *tab;
    size_t cap;               // power of two
    size_t used;              // live entries
    size_t fill;              // live + erased (load-factor gate)
    size_t tombstones;        // live entries with val < 0
    int lazy_crc;             // payload CRC deferred to overlay_pop
};

// Table allocation: large tables go through mmap + MADV_HUGEPAGE.
// With 4 KB pages a 100+ MB table defeats software prefetching — the
// TLB holds ~1.5K entries, so nearly every slot probe is also a TLB
// miss, and x86 drops prefetch hints that miss the TLB. 2 MB pages
// keep the whole table TLB-resident (measured 2.6 -> 9M+ rec/s on a
// 2M-distinct-key replay).
#include <sys/mman.h>

static OvEntry *ov_alloc(size_t cap) {
    size_t bytes = cap * sizeof(OvEntry);
    if (bytes >= (2u << 20)) {       // size also decides ov_free's path
        void *p = mmap(NULL, bytes, PROT_READ | PROT_WRITE,
                       MAP_PRIVATE | MAP_ANONYMOUS, -1, 0);
        if (p == MAP_FAILED) return NULL;
#ifdef MADV_HUGEPAGE
        madvise(p, bytes, MADV_HUGEPAGE);
#endif
        return (OvEntry *)p;         // anonymous mmap is zero-filled
    }
    return (OvEntry *)calloc(cap, sizeof(OvEntry));
}

static void ov_free(OvEntry *tab, size_t cap) {
    if (!tab) return;
    size_t bytes = cap * sizeof(OvEntry);
    if (bytes >= (2u << 20)) munmap(tab, bytes);
    else free(tab);
}

static inline uint32_t ov_hash(const char *p, size_t n) {
    uint64_t h = 1469598103934665603ULL
        ^ ((uint64_t)n * 0x9E3779B97F4A7C15ULL);
    while (n >= 8) {
        uint64_t v; memcpy(&v, p, 8);
        h = (h ^ v) * 0x9E3779B97F4A7C15ULL; h ^= h >> 29;
        p += 8; n -= 8;
    }
    uint64_t v = 0;
    if (n) memcpy(&v, p, n);
    h = (h ^ v) * 0x9E3779B97F4A7C15ULL;
    h ^= h >> 32;
    uint32_t h32 = (uint32_t)h;
    return h32 < 2 ? h32 + 2 : h32;
}

static void ov_grow(WalOverlay *ov, size_t newcap) {
    OvEntry *nt = ov_alloc(newcap);
    if (!nt) return;                       // keep probing the old table
    size_t mask = newcap - 1;
    for (size_t i = 0; i < ov->cap; i++) {
        OvEntry *e = &ov->tab[i];
        if (e->hash < 2) continue;
        size_t j = e->hash & mask;
        while (nt[j].hash) j = (j + 1) & mask;
        nt[j] = *e;
    }
    ov_free(ov->tab, ov->cap);
    ov->tab = nt; ov->cap = newcap; ov->fill = ov->used;
}

// find-or-insert; *fresh tells whether the slot is new (val unset).
// Takes the precomputed hash so the replay loop can prefetch the slot
// a batch ahead of the probe.
static OvEntry *ov_upsert_h(WalOverlay *ov, const char *key,
                            uint32_t klen, uint64_t koff, uint32_t h,
                            int *fresh) {
    if ((ov->fill + 1) * 10 >= ov->cap * 7)
        ov_grow(ov, ov->cap * 2);
    size_t mask = ov->cap - 1, i = h & mask;
    Py_ssize_t erased = -1;
    for (;;) {
        OvEntry *e = &ov->tab[i];
        if (e->hash == 0) {
            if (erased >= 0) e = &ov->tab[erased];
            else ov->fill++;
            e->hash = h; e->koff = koff; e->klen = klen;
            ov->used++; *fresh = 1;
            return e;
        }
        if (e->hash == 1) {
            if (erased < 0) erased = (Py_ssize_t)i;
        } else if (e->hash == h && e->klen == klen
                   && memcmp(ov->base + e->koff, key, klen) == 0) {
            // refresh koff to the NEW frame: callers update val/flen
            // to the latest frame, and the lazy-CRC check in
            // overlay_pop derives the frame start from koff — a stale
            // koff made it verify the OLD frame's bytes against the
            // OLD CRC using the NEW length (spurious failure on a
            // length change; unverified decode on a same-length
            // update). Key bytes are identical (memcmp above), so the
            // swap preserves key identity.
            e->koff = koff;
            *fresh = 0;
            return e;
        }
        i = (i + 1) & mask;
    }
}

static OvEntry *ov_find(WalOverlay *ov, const char *key, size_t klen) {
    uint32_t h = ov_hash(key, klen);
    size_t mask = ov->cap - 1, i = h & mask;
    for (;;) {
        OvEntry *e = &ov->tab[i];
        if (e->hash == 0) return NULL;
        if (e->hash >= 2 && e->hash == h && e->klen == (uint32_t)klen
            && memcmp(ov->base + e->koff, key, klen) == 0)
            return e;
        i = (i + 1) & mask;
    }
}

static void overlay_destroy(PyObject *cap) {
    WalOverlay *ov = (WalOverlay *)PyCapsule_GetPointer(cap,
                                                        "neumann.walov");
    if (ov) {
        PyBuffer_Release(&ov->view);
        Py_XDECREF(ov->buf);
        ov_free(ov->tab, ov->cap);
        delete ov;
    }
}

// wal_overlay(buf_bytes[, lazy_crc]) -> (capsule, n_records)
static PyObject *py_wal_overlay(PyObject *self, PyObject *args) {
    // any C-contiguous buffer: bytes, or an mmap of the WAL file
    // (recover() mmaps — a read() of the log costs a full memcpy,
    // which dominated replay at ~1 GB/s on cloud VMs).
    //
    // lazy_crc=1 defers each payload's CRC to overlay_pop: the parse
    // touches only the 8-byte headers + 5-byte record prefixes, so
    // replay runs at header rate instead of full-payload CRC rate.
    // Every byte is still CRC-verified BEFORE first use (pop); the
    // trade is that a mid-log corruption surfaces at access time (as
    // ValueError from pop) instead of truncating replay at parse time.
    PyObject *bufobj;
    int lazy = 0;
    if (!PyArg_ParseTuple(args, "O|i", &bufobj, &lazy)) return NULL;
    WalOverlay *ov = new WalOverlay();
    if (PyObject_GetBuffer(bufobj, &ov->view, PyBUF_SIMPLE) < 0) {
        delete ov;
        return NULL;
    }
    const unsigned char *buf = (const unsigned char *)ov->view.buf;
    Py_ssize_t len = ov->view.len, pos = 0;
    ov->buf = Py_NewRef(bufobj);
    ov->blen = len;
    ov->base = (const char *)buf;
    ov->used = ov->fill = ov->tombstones = 0;
    ov->lazy_crc = lazy;
    // start small and double: a len-proportional pre-size costs more
    // in calloc page faults than the amortized rehashes save
    ov->cap = 1 << 16;
    ov->tab = ov_alloc(ov->cap);
    if (!ov->tab) {
        Py_DECREF(ov->buf); delete ov;
        return PyErr_NoMemory();
    }
    long n = 0;
    if (len < (Py_ssize_t)(2 << 20)) {
        // SMALL log: the whole buffer is (or will immediately be)
        // cache-resident, so the software-pipelined walk below is
        // pure bookkeeping overhead — its prefetches, two-batch
        // staging, and stride guessing bought nothing in-cache
        // (measured 13.9 -> 39 M rec/s on 10K-record logs from this
        // simple loop, but 13.9 -> 7.9 at 9.6 MB where the pipelined
        // walk's prefetches matter). One tight pass per record.
        int bad = 0;
        // pre-size from the first frame's stride (same rationale as
        // the pipelined path's priming)
        if (len >= 12) {
            uint32_t flen0;
            memcpy(&flen0, buf, 4);
            Py_ssize_t stride0 = 8 + (Py_ssize_t)flen0;
            if (stride0 > 8) {
                size_t est = (size_t)(len / stride0) * 2 + 1;
                size_t cap = ov->cap;
                while (cap < est && cap < ((size_t)1 << 23))
                    cap <<= 1;
                if (cap > ov->cap) ov_grow(ov, cap);
            }
        }
        while (pos + 8 <= len && !bad) {
            uint32_t flen, crc;
            memcpy(&flen, buf + pos, 4);
            memcpy(&crc, buf + pos + 4, 4);
            if ((Py_ssize_t)flen > len - pos - 8) break;  // torn tail
            const unsigned char *payload = buf + pos + 8;
            if ((!lazy || pos + 8 + (Py_ssize_t)flen == len
                 || pos + 8 + (Py_ssize_t)flen + 8 > len)
                && fast_crc(payload, flen) != crc) break;
            if (flen < 5) {
                if (lazy) break;
                goto malformed;
            }
            unsigned op = payload[0];
            uint32_t klen;
            memcpy(&klen, payload + 1, 4);
            if ((Py_ssize_t)klen > (Py_ssize_t)flen - 5) {
                if (lazy) break;
                goto malformed;
            }
            if (op > 1) {
                if (lazy) break;
                goto malformed;
            }
            uint64_t koff = (uint64_t)(pos + 8 + 5);
            uint32_t h = ov_hash(ov->base + koff, klen);
            int fresh;
            OvEntry *e = ov_upsert_h(ov, ov->base + koff, klen, koff,
                                     h, &fresh);
            if (op == 0) {
                if (!fresh && e->val < 0) ov->tombstones--;
                e->val = (Py_ssize_t)(pos + 8 + 5 + klen);
                e->flen = flen;
            } else {
                if (fresh || e->val >= 0) ov->tombstones++;
                e->val = -1;
            }
            n++;
            pos += 8 + (Py_ssize_t)flen;
        }
        return Py_BuildValue(
            "(Nl)", PyCapsule_New(ov, "neumann.walov", overlay_destroy),
            n);
    }
    // Software-pipelined walk. The frame chain is a serial pointer
    // chase (each header address depends on the previous frame's
    // length — one DRAM latency per 570B record) and every upsert's
    // slot probe is a second dependent random access; together they
    // capped replay at ~4.7M rec/s. Batching B frames per round
    // overlaps those latencies: (1) decode B headers while issuing
    // stride-guess prefetches for upcoming frames (embedding logs have
    // near-uniform record sizes, so pos + k*stride is almost always
    // the k-th next header), (2) hash all B keys and prefetch their
    // table slots, (3) run the B upserts against now-resident lines.
    // Two batches are kept in flight (decode+hash batch i+1, then
    // upsert batch i) so every slot prefetch gets a full batch of
    // decode work to land behind.
    {
        enum { B = 64 };
        struct Rec {
            uint64_t koff;
            Py_ssize_t val;
            uint32_t klen, flen, hash;
            uint8_t op;
        };
        Rec recs2[2][B];
        int nb2[2] = {0, 0};
        int cur = 0, primed = 0, bad = 0;
        while (pos + 8 <= len && !bad) {
            Rec *recs = recs2[cur];
            int nb = 0;
            while (nb < B && pos + 8 <= len) {
                uint32_t flen, crc;
                memcpy(&flen, buf + pos, 4);
                memcpy(&crc, buf + pos + 4, 4);
                if ((Py_ssize_t)flen > len - pos - 8) {   // torn tail
                    bad = 1;
                    break;
                }
                const unsigned char *payload = buf + pos + 8;
                // lazy mode: the FINAL frame is always CRC-checked
                // here (a torn buffered write lands there), the rest
                // defer to pop
                if ((!lazy || pos + 8 + (Py_ssize_t)flen == len
                     || pos + 8 + (Py_ssize_t)flen + 8 > len)
                    && fast_crc(payload, flen) != crc) {  // corrupt
                    bad = 1;
                    break;
                }
                // structurally malformed frame: in lazy mode the
                // frame was NOT CRC-verified above, so a bit flip in
                // a length/header lands here — treat it exactly like
                // an eager-mode CRC failure (truncate, keep the
                // records parsed so far) instead of failing the whole
                // recovery. Eager mode reaches here only when the CRC
                // matched, i.e. a genuinely malformed record: raise.
                if (flen < 5) {
                    if (lazy) { bad = 1; break; }
                    goto malformed;
                }
                unsigned op = payload[0];
                uint32_t klen;
                memcpy(&klen, payload + 1, 4);
                if ((Py_ssize_t)klen > (Py_ssize_t)flen - 5) {
                    if (lazy) { bad = 1; break; }
                    goto malformed;
                }
                if (op > 1) {
                    if (lazy) { bad = 1; break; }
                    goto malformed;
                }
                Rec *r = &recs[nb++];
                r->koff = (uint64_t)(pos + 8 + 5);
                r->klen = klen;
                r->flen = flen;
                r->op = (uint8_t)op;
                r->val = op == 0
                    ? (Py_ssize_t)(pos + 8 + 5 + klen) : -1;
                Py_ssize_t stride = 8 + (Py_ssize_t)flen;
                pos += stride;
                // prefetch hints never fault, so running past len at
                // the tail is fine
                __builtin_prefetch(buf + pos + stride);
                __builtin_prefetch(buf + pos + 2 * stride);
                __builtin_prefetch(buf + pos + 3 * stride);
            }
            nb2[cur] = nb;
            if (!primed && nb == B && pos + 8 <= len) {
                // pre-size the table once from the observed stride so
                // a uniform log never pays the doubling-rehash cascade
                // (each rehash re-touches every entry at DRAM latency)
                Py_ssize_t stride0 = (Py_ssize_t)
                    ((pos / (Py_ssize_t)nb));
                if (stride0 > 0) {
                    // record count bounds distinct keys from above;
                    // cap the guess (update-heavy logs have far fewer
                    // keys than records — doubling takes over there)
                    size_t est = (size_t)(len / stride0) * 2 + 1;
                    size_t cap = ov->cap;
                    while (cap < est && cap < ((size_t)1 << 23))
                        cap <<= 1;
                    if (cap > ov->cap) ov_grow(ov, cap);
                }
                primed = 1;
            }
            size_t mask = ov->cap - 1;
            for (int i = 0; i < nb; i++) {
                recs[i].hash = ov_hash(ov->base + recs[i].koff,
                                       recs[i].klen);
                __builtin_prefetch(&ov->tab[recs[i].hash & mask]);
            }
            // upsert the PREVIOUS batch: its slot prefetches have had
            // this whole batch's decode+hash work to land
            int prev = cur ^ 1;
            for (int i = 0; i < nb2[prev]; i++) {
                Rec *r = &recs2[prev][i];
                int fresh;
                OvEntry *e = ov_upsert_h(ov, ov->base + r->koff,
                                         r->klen, r->koff, r->hash,
                                         &fresh);
                if (r->op == 0) {
                    if (!fresh && e->val < 0) ov->tombstones--;
                    e->val = r->val;
                    e->flen = r->flen;
                } else {
                    if (fresh || e->val >= 0) ov->tombstones++;
                    e->val = -1;
                }
            }
            n += nb2[prev];
            nb2[prev] = 0;
            cur = prev;
        }
        // drain the final in-flight batch
        for (int b = 0; b < 2; b++) {
            for (int i = 0; i < nb2[b]; i++) {
                Rec *r = &recs2[b][i];
                int fresh;
                OvEntry *e = ov_upsert_h(ov, ov->base + r->koff,
                                         r->klen, r->koff, r->hash,
                                         &fresh);
                if (r->op == 0) {
                    if (!fresh && e->val < 0) ov->tombstones--;
                    e->val = r->val;
                    e->flen = r->flen;
                } else {
                    if (fresh || e->val >= 0) ov->tombstones++;
                    e->val = -1;
                }
            }
            n += nb2[b];
        }
    }
    return Py_BuildValue(
        "(Nl)", PyCapsule_New(ov, "neumann.walov", overlay_destroy), n);
malformed:
    PyBuffer_Release(&ov->view);
    Py_DECREF(ov->buf);
    ov_free(ov->tab, ov->cap);
    delete ov;
    PyErr_SetString(PyExc_ValueError, "malformed WAL record");
    return NULL;
}

static WalOverlay *overlay_of(PyObject *cap) {
    return (WalOverlay *)PyCapsule_GetPointer(cap, "neumann.walov");
}

// overlay_pop(capsule, key) -> (code, td) code: 0 absent, 1 put, 2 del
static PyObject *py_overlay_pop(PyObject *self, PyObject *args) {
    PyObject *cap;
    const char *key;
    Py_ssize_t klen;
    if (!PyArg_ParseTuple(args, "Os#", &cap, &key, &klen)) return NULL;
    WalOverlay *ov = overlay_of(cap);
    if (!ov) return NULL;
    OvEntry *e = ov_find(ov, key, (size_t)klen);
    if (!e)
        return Py_BuildValue("(iO)", 0, Py_None);
    Py_ssize_t p = e->val;
    uint32_t flen = e->flen, klen_e = e->klen;
    uint64_t koff = e->koff;
    if (p < 0) ov->tombstones--;
    e->hash = 1;                           // erased slot
    ov->used--;
    if (p < 0)
        return Py_BuildValue("(iO)", 2, Py_None);
    if (ov->lazy_crc) {
        // deferred integrity: verify the whole frame before any byte
        // of it is decoded (koff = frame payload start + 5)
        const unsigned char *payload =
            (const unsigned char *)ov->base + koff - 5;
        uint32_t want;
        memcpy(&want, payload - 4, 4);
        (void)klen_e;
        if (fast_crc(payload, flen) != want) {
            PyErr_SetString(PyExc_ValueError,
                            "WAL record failed deferred CRC");
            return NULL;
        }
    }
    Rd r = {(const unsigned char *)ov->base, ov->blen, p};
    PyObject *td = decode_data_c(&r);
    if (!td) return NULL;
    return Py_BuildValue("(iN)", 1, td);
}

// overlay_keys(capsule) -> (put_keys_list, tombstone_keys_list)
static PyObject *py_overlay_keys(PyObject *self, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    WalOverlay *ov = overlay_of(cap);
    if (!ov) return NULL;
    PyObject *puts = PyList_New(0), *dels = PyList_New(0);
    if (!puts || !dels) { Py_XDECREF(puts); Py_XDECREF(dels); return NULL; }
    for (size_t i = 0; i < ov->cap; i++) {
        OvEntry *e = &ov->tab[i];
        if (e->hash < 2) continue;
        PyObject *k = PyUnicode_DecodeUTF8(ov->base + e->koff,
                                           e->klen, "replace");
        if (!k || PyList_Append(e->val < 0 ? dels : puts, k) < 0) {
            Py_XDECREF(k); Py_DECREF(puts); Py_DECREF(dels);
            return NULL;
        }
        Py_DECREF(k);
    }
    return Py_BuildValue("(NN)", puts, dels);
}

// overlay_tombstones(capsule) -> list of tombstoned keys (only)
static PyObject *py_overlay_tombstones(PyObject *self, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    WalOverlay *ov = overlay_of(cap);
    if (!ov) return NULL;
    // clean logs (no deletes) skip the full-table scan — this runs on
    // every recover(), and the scan cost rivaled the parse on small logs
    if (ov->tombstones == 0) return PyList_New(0);
    PyObject *dels = PyList_New(0);
    if (!dels) return NULL;
    for (size_t i = 0; i < ov->cap; i++) {
        OvEntry *e = &ov->tab[i];
        if (e->hash < 2 || e->val >= 0) continue;
        PyObject *k = PyUnicode_DecodeUTF8(ov->base + e->koff,
                                           e->klen, "replace");
        if (!k || PyList_Append(dels, k) < 0) {
            Py_XDECREF(k); Py_DECREF(dels); return NULL;
        }
        Py_DECREF(k);
    }
    return dels;
}

// crc_fast_ok() -> bool (did the sliced CRC pass its self-check?)
static PyObject *py_crc_fast_ok(PyObject *self, PyObject *args) {
    return PyBool_FromLong(s16_ok);
}

// overlay_count(capsule) -> live put count
static PyObject *py_overlay_count(PyObject *self, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    WalOverlay *ov = overlay_of(cap);
    if (!ov) return NULL;
    return PyLong_FromSize_t(ov->used - ov->tombstones);
}

// snapshot_lazy(body_bytes, count, lazy_cls) -> dict[str, lazy]
// Snapshot-body load without materializing records: each entry becomes
// a slot-only lazy wrapper over (body, payload offset) — same
// promote-on-read economics as the WAL overlay, but snapshots already
// need the name->record dict so a Python dict of wrappers is right.
static PyObject *py_snapshot_lazy(PyObject *self, PyObject *args) {
    PyObject *bufobj, *lazy_cls;
    Py_ssize_t count;
    if (!PyArg_ParseTuple(args, "SnO", &bufobj, &count, &lazy_cls))
        return NULL;
    const unsigned char *buf =
        (const unsigned char *)PyBytes_AS_STRING(bufobj);
    Py_ssize_t len = PyBytes_GET_SIZE(bufobj);
    PyObject *d_lbuf = PyObject_GetAttrString(lazy_cls, "_buf");
    PyObject *d_lpos = PyObject_GetAttrString(lazy_cls, "_pos");
    PyObject *d_lmat = PyObject_GetAttrString(lazy_cls, "_mat");
    PyObject *out = PyDict_New();
    Rd r = {buf, len, 0};
    if (!d_lbuf || !d_lpos || !d_lmat || !out) goto fail;
    for (Py_ssize_t i = 0; i < count; i++) {
        const char *kp; Py_ssize_t kn;
        uint32_t plen;
        if (!rd_span(&r, &kp, &kn)) goto fail;
        if (!rd_u32(&r, &plen) || !rd_need(&r, (Py_ssize_t)plen))
            goto fail;
        {
            PyObject *key = PyUnicode_DecodeUTF8(kp, kn, "replace");
            PyObject *obj = key ? new_instance(lazy_cls) : NULL;
            PyObject *p = obj ? PyLong_FromSsize_t(r.pos) : NULL;
            if (!key || !obj || !p
                || Py_TYPE(d_lbuf)->tp_descr_set(d_lbuf, obj,
                                                 bufobj) < 0
                || Py_TYPE(d_lpos)->tp_descr_set(d_lpos, obj, p) < 0
                || Py_TYPE(d_lmat)->tp_descr_set(d_lmat, obj,
                                                 Py_None) < 0
                || PyDict_SetItem(out, key, obj) < 0) {
                Py_XDECREF(p); Py_XDECREF(obj); Py_XDECREF(key);
                goto fail;
            }
            Py_DECREF(p); Py_DECREF(obj); Py_DECREF(key);
        }
        r.pos += plen;
    }
    Py_DECREF(d_lbuf); Py_DECREF(d_lpos); Py_DECREF(d_lmat);
    return out;
fail:
    Py_XDECREF(d_lbuf); Py_XDECREF(d_lpos); Py_XDECREF(d_lmat);
    Py_XDECREF(out);
    return NULL;
}

// wal_apply(buf_bytes, lazy_cls) -> (dict, n_records)
// Bulk replay: one C pass over the frames; the returned dict maps each
// key to its FINAL state — a lazy wrapper (slot-only, no per-record
// field decode) for puts, None for deletes. The caller merges it into
// the store map, so a malformed record aborts before any mutation.
static PyObject *py_wal_apply(PyObject *self, PyObject *args) {
    PyObject *bufobj, *lazy_cls;
    if (!PyArg_ParseTuple(args, "SO", &bufobj, &lazy_cls)) return NULL;
    const unsigned char *buf =
        (const unsigned char *)PyBytes_AS_STRING(bufobj);
    Py_ssize_t len = PyBytes_GET_SIZE(bufobj), pos = 0;
    // slot member descriptors of the lazy class (set bypasses __init__)
    PyObject *d_lbuf = PyObject_GetAttrString(lazy_cls, "_buf");
    PyObject *d_lpos = PyObject_GetAttrString(lazy_cls, "_pos");
    PyObject *d_lmat = PyObject_GetAttrString(lazy_cls, "_mat");
    PyObject *out = PyDict_New();
    long n = 0;
    if (!d_lbuf || !d_lpos || !d_lmat || !out) goto fail;
    while (pos + 8 <= len) {
        uint32_t flen, crc;
        memcpy(&flen, buf + pos, 4);
        memcpy(&crc, buf + pos + 4, 4);
        if ((Py_ssize_t)flen > len - pos - 8) break;      // torn tail
        const unsigned char *payload = buf + pos + 8;
        if (fast_crc(payload, flen) != crc) break;
        {
            Rd r = {payload, (Py_ssize_t)flen, 0};
            unsigned op;
            if (!rd_u8(&r, &op)) goto fail;
            PyObject *key = rd_str(&r);
            if (!key) goto fail;
            if (op == 0) {
                PyObject *obj = new_instance(lazy_cls);
                PyObject *p = obj ? PyLong_FromSsize_t(
                    pos + 8 + r.pos) : NULL;
                if (!obj || !p
                    || Py_TYPE(d_lbuf)->tp_descr_set(d_lbuf, obj,
                                                     bufobj) < 0
                    || Py_TYPE(d_lpos)->tp_descr_set(d_lpos, obj,
                                                     p) < 0
                    || Py_TYPE(d_lmat)->tp_descr_set(d_lmat, obj,
                                                     Py_None) < 0
                    || PyDict_SetItem(out, key, obj) < 0) {
                    Py_XDECREF(p);
                    Py_XDECREF(obj);
                    Py_DECREF(key);
                    goto fail;
                }
                Py_DECREF(p);
                Py_DECREF(obj);
            } else if (op == 1) {
                if (PyDict_SetItem(out, key, Py_None) < 0) {
                    Py_DECREF(key);
                    goto fail;
                }
            } else {
                PyErr_Format(PyExc_ValueError, "unknown WAL op %u",
                             op);
                Py_DECREF(key);
                goto fail;
            }
            Py_DECREF(key);
        }
        n++;
        pos += 8 + (Py_ssize_t)flen;
    }
    Py_DECREF(d_lbuf);
    Py_DECREF(d_lpos);
    Py_DECREF(d_lmat);
    {
        PyObject *res = Py_BuildValue("(Nl)", out, n);
        return res;
    }
fail:
    Py_XDECREF(d_lbuf);
    Py_XDECREF(d_lpos);
    Py_XDECREF(d_lmat);
    Py_XDECREF(out);
    return NULL;
}

// decode_snapshot_body(body, count) -> dict[str, TensorData]
static PyObject *py_decode_snapshot_body(PyObject *self, PyObject *args) {
    Py_buffer view;
    Py_ssize_t count;
    if (!PyArg_ParseTuple(args, "y*n", &view, &count)) return NULL;
    Rd r = {(const unsigned char *)view.buf, view.len, 0};
    PyObject *out = PyDict_New();
    if (!out) { PyBuffer_Release(&view); return NULL; }
    for (Py_ssize_t i = 0; i < count; i++) {
        const char *kp; Py_ssize_t kn;
        if (!rd_span(&r, &kp, &kn)) goto fail;
        PyObject *key = PyUnicode_DecodeUTF8(kp, kn, "replace");
        if (!key) goto fail;
        uint32_t plen;
        if (!rd_u32(&r, &plen) || !rd_need(&r, (Py_ssize_t)plen)) {
            Py_DECREF(key);
            goto fail;
        }
        Rd pr = {r.p + r.pos, (Py_ssize_t)plen, 0};
        r.pos += plen;
        PyObject *td = decode_data_c(&pr);
        if (!td) { Py_DECREF(key); goto fail; }
        int rc = PyDict_SetItem(out, key, td);
        Py_DECREF(key);
        Py_DECREF(td);
        if (rc != 0) goto fail;
    }
    PyBuffer_Release(&view);
    return out;
fail:
    Py_DECREF(out);
    PyBuffer_Release(&view);
    return NULL;
}

// ---- growable write buffer -------------------------------------------

typedef struct {
    unsigned char *b;
    size_t len, cap;
    int fixed;                 // b is a borrowed static buffer
} Wr;

static int wr_reserve(Wr *w, size_t extra) {
    if (w->len + extra <= w->cap) return 1;
    size_t cap = w->cap ? w->cap * 2 : 256;
    while (cap < w->len + extra) cap *= 2;
    unsigned char *nb;
    if (w->fixed) {            // spill the static buffer to the heap
        nb = (unsigned char *)malloc(cap);
        if (nb) memcpy(nb, w->b, w->len);
        w->fixed = 0;
    } else {
        nb = (unsigned char *)realloc(w->b, cap);
    }
    if (!nb) { PyErr_NoMemory(); return 0; }
    w->b = nb;
    w->cap = cap;
    return 1;
}

static void wr_free(Wr *w) {
    if (!w->fixed) free(w->b);
}

static int wr_put(Wr *w, const void *p, size_t n) {
    if (!wr_reserve(w, n)) return 0;
    memcpy(w->b + w->len, p, n);
    w->len += n;
    return 1;
}

static int wr_u8(Wr *w, unsigned char v) { return wr_put(w, &v, 1); }
static int wr_u32(Wr *w, uint32_t v) { return wr_put(w, &v, 4); }

static int wr_pystr(Wr *w, PyObject *s) {
    Py_ssize_t n;
    const char *p = PyUnicode_AsUTF8AndSize(s, &n);
    if (!p) return 0;
    return wr_u32(w, (uint32_t)n) && wr_put(w, p, (size_t)n);
}

static int wr_pybytes_span(Wr *w, PyObject *b) {
    char *p; Py_ssize_t n;
    if (PyBytes_AsStringAndSize(b, &p, &n) != 0) return 0;
    return wr_u32(w, (uint32_t)n) && wr_put(w, p, (size_t)n);
}

// ---- value / data encode ---------------------------------------------

static int kind_is(PyObject *k, PyObject *cached) {
    if (k == cached) return 1;
    if (!PyUnicode_Check(k)) return 0;
    return PyUnicode_Compare(k, cached) == 0;
}

static int encode_f4_payload(Wr *w, PyObject *value) {
    // fast path: contiguous float32 buffer (ndarray)
    Py_buffer bv;
    if (PyObject_GetBuffer(value, &bv, PyBUF_CONTIG_RO | PyBUF_FORMAT)
            == 0) {
        if (bv.itemsize == 4 && bv.format && bv.format[0] == 'f'
                && bv.format[1] == '\0') {
            int ok = wr_u32(w, (uint32_t)bv.len)
                && wr_put(w, bv.buf, (size_t)bv.len);
            PyBuffer_Release(&bv);
            return ok;
        }
        PyBuffer_Release(&bv);
    } else {
        PyErr_Clear();
    }
    PyObject *b = PyObject_CallOneArg(g_as_f4_bytes, value);
    if (!b) return 0;
    int ok = wr_pybytes_span(w, b);
    Py_DECREF(b);
    return ok;
}

static int encode_value_c(Wr *w, PyObject *tv) {
    PyObject *kind = PyObject_GetAttr(tv, s_kind);
    if (!kind) return 0;
    PyObject *value = PyObject_GetAttr(tv, s_value);
    if (!value) { Py_DECREF(kind); return 0; }
    int ok = 0;
    if (kind_is(kind, k_scalar)) {
        if (value == Py_None) {
            ok = wr_u8(w, 0);
        } else if (PyBool_Check(value)) {
            ok = wr_u8(w, 1) && wr_u8(w, value == Py_True ? 1 : 0);
        } else if (PyLong_Check(value)) {
            int64_t v = PyLong_AsLongLong(value);
            if (v == -1 && PyErr_Occurred()) goto done;
            ok = wr_u8(w, 2) && wr_put(w, &v, 8);
        } else if (PyFloat_Check(value)) {
            double v = PyFloat_AS_DOUBLE(value);
            ok = wr_u8(w, 3) && wr_put(w, &v, 8);
        } else if (PyUnicode_Check(value)) {
            ok = wr_u8(w, 4) && wr_pystr(w, value);
        } else if (PyBytes_Check(value)) {
            ok = wr_u8(w, 5) && wr_pybytes_span(w, value);
        } else {
            PyErr_Format(PyExc_ValueError, "unencodable scalar type %s",
                         Py_TYPE(value)->tp_name);
        }
    } else if (kind_is(kind, k_vector)) {
        ok = wr_u8(w, 6) && encode_f4_payload(w, value);
    } else if (kind_is(kind, k_sparse)) {
        PyObject *parts = PyObject_CallOneArg(g_sparse_parts, value);
        if (!parts) goto done;
        PyObject *dim, *pb, *vb;
        if (!PyArg_ParseTuple(parts, "OOO", &dim, &pb, &vb)) {
            Py_DECREF(parts);
            goto done;
        }
        uint32_t d = (uint32_t)PyLong_AsUnsignedLongMask(dim);
        ok = wr_u8(w, 7) && wr_u32(w, d) && wr_pybytes_span(w, pb)
            && wr_pybytes_span(w, vb);
        Py_DECREF(parts);
    } else if (kind_is(kind, k_pointer)) {
        ok = wr_u8(w, 8) && wr_pystr(w, value);
    } else if (kind_is(kind, k_pointers)) {
        PyObject *seq = PySequence_Fast(value, "pointers not a sequence");
        if (!seq) goto done;
        Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
        ok = wr_u8(w, 9) && wr_u32(w, (uint32_t)n);
        for (Py_ssize_t i = 0; ok && i < n; i++)
            ok = wr_pystr(w, PySequence_Fast_GET_ITEM(seq, i));
        Py_DECREF(seq);
    } else {
        PyErr_Format(PyExc_ValueError, "unencodable value kind %R", kind);
    }
done:
    Py_DECREF(kind);
    Py_DECREF(value);
    return ok;
}

static int encode_data_c(Wr *w, PyObject *td) {
    PyObject *fields = PyObject_GetAttr(td, s_fields);
    if (!fields) return 0;
    if (!PyDict_Check(fields)) {
        Py_DECREF(fields);
        PyErr_SetString(PyExc_ValueError, "fields is not a dict");
        return 0;
    }
    if (!wr_u32(w, (uint32_t)PyDict_GET_SIZE(fields))) {
        Py_DECREF(fields);
        return 0;
    }
    Py_ssize_t p = 0;
    PyObject *name, *val;
    while (PyDict_Next(fields, &p, &name, &val)) {
        if (!PyUnicode_Check(name)) {
            PyErr_SetString(PyExc_ValueError, "field name not a str");
            Py_DECREF(fields);
            return 0;
        }
        if (!wr_pystr(w, name) || !encode_value_c(w, val)) {
            Py_DECREF(fields);
            return 0;
        }
    }
    Py_DECREF(fields);
    return 1;
}

static PyObject *wr_to_bytes(Wr *w) {
    PyObject *out = PyBytes_FromStringAndSize((const char *)w->b,
                                              (Py_ssize_t)w->len);
    wr_free(w);
    return out;
}

// encode_data(td) -> bytes
static PyObject *py_encode_data(PyObject *self, PyObject *td) {
    Wr w = {NULL, 0, 0, 0};
    if (!encode_data_c(&w, td)) { wr_free(&w); return NULL; }
    return wr_to_bytes(&w);
}

// payload = op u8 + klen u32 + key + [data]; frame = len u32 + crc u32
static int encode_frame_c(Wr *w, long op, PyObject *key, PyObject *td) {
    size_t hdr_at = w->len;
    if (!wr_u32(w, 0) || !wr_u32(w, 0)) return 0;  // patched below
    size_t start = w->len;
    if (!wr_u8(w, (unsigned char)op) || !wr_pystr(w, key)) return 0;
    if (op == 0 && !encode_data_c(w, td)) return 0;
    uint32_t flen = (uint32_t)(w->len - start);
    uint32_t crc = fast_crc(w->b + start, flen);
    memcpy(w->b + hdr_at, &flen, 4);
    memcpy(w->b + hdr_at + 4, &crc, 4);
    return 1;
}

// encode_frame(op:int, key:str, td|None) -> bytes
static unsigned char enc_scratch[1 << 16];
static int enc_scratch_busy = 0;

static PyObject *py_encode_frame(PyObject *self,
                                 PyObject *const *args, Py_ssize_t n) {
    if (n < 2 || n > 3) {
        PyErr_SetString(PyExc_TypeError,
                        "encode_frame(op, key[, data])");
        return NULL;
    }
    long op = PyLong_AsLong(args[0]);
    if (op == -1 && PyErr_Occurred()) return NULL;
    PyObject *key = args[1], *td = n == 3 ? args[2] : Py_None;
    if (!PyUnicode_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "key must be str");
        return NULL;
    }
    Wr w;
    if (!enc_scratch_busy) {
        enc_scratch_busy = 1;
        w = (Wr){enc_scratch, 0, sizeof enc_scratch, 1};
        PyObject *out = encode_frame_c(&w, op, key, td)
            ? wr_to_bytes(&w) : (wr_free(&w), (PyObject *)NULL);
        enc_scratch_busy = 0;
        return out;
    }
    w = (Wr){NULL, 0, 0, 0};
    if (!encode_frame_c(&w, op, key, td)) { wr_free(&w); return NULL; }
    return wr_to_bytes(&w);
}

// ---- C-side frame buffer: one call per append ------------------------
// put -> framebuf_append is a single C call (encode + buffer); the
// Python WAL drains it to the file object at its sync barriers, so
// durability semantics are unchanged while the per-record Python
// frame stack (log_put -> _append_frame -> BufferedWriter.write)
// disappears from the hot path.

static void framebuf_destroy(PyObject *cap) {
    Wr *w = (Wr *)PyCapsule_GetPointer(cap, "neumann.framebuf");
    if (w) { wr_free(w); delete w; }
}

static PyObject *py_framebuf_new(PyObject *self, PyObject *args) {
    Wr *w = new Wr();
    w->b = NULL; w->len = w->cap = 0; w->fixed = 0;
    return PyCapsule_New(w, "neumann.framebuf", framebuf_destroy);
}

// framebuf_append(cap, op, key[, td]) -> buffered byte count
static PyObject *py_framebuf_append(PyObject *self,
                                    PyObject *const *args,
                                    Py_ssize_t n) {
    if (n < 3 || n > 4) {
        PyErr_SetString(PyExc_TypeError,
                        "framebuf_append(cap, op, key[, data])");
        return NULL;
    }
    Wr *fb = (Wr *)PyCapsule_GetPointer(args[0], "neumann.framebuf");
    if (!fb) return NULL;
    long op = PyLong_AsLong(args[1]);
    if (op == -1 && PyErr_Occurred()) return NULL;
    PyObject *key = args[2], *td = n == 4 ? args[3] : Py_None;
    if (!PyUnicode_Check(key)) {
        PyErr_SetString(PyExc_TypeError, "key must be str");
        return NULL;
    }
    // encode into a local writer first: encode may re-enter Python
    // (lazy-field property getters), and a nested append must not
    // interleave inside this frame's bytes
    Wr w;
    int used_scratch = !enc_scratch_busy;
    if (used_scratch) {
        enc_scratch_busy = 1;
        w = (Wr){enc_scratch, 0, sizeof enc_scratch, 1};
    } else {
        w = (Wr){NULL, 0, 0, 0};
    }
    int ok = encode_frame_c(&w, op, key, td)
        && wr_put(fb, w.b, w.len);
    wr_free(&w);
    if (used_scratch) enc_scratch_busy = 0;
    if (!ok) return NULL;
    return PyLong_FromSize_t(fb->len);
}

// framebuf_take(cap) -> bytes (drains the buffer)
static PyObject *py_framebuf_take(PyObject *self, PyObject *args) {
    PyObject *cap;
    if (!PyArg_ParseTuple(args, "O", &cap)) return NULL;
    Wr *fb = (Wr *)PyCapsule_GetPointer(cap, "neumann.framebuf");
    if (!fb) return NULL;
    PyObject *out = PyBytes_FromStringAndSize((const char *)fb->b,
                                              (Py_ssize_t)fb->len);
    fb->len = 0;                          // keep capacity for reuse
    return out;
}

// encode_frames(iterable of (op:int, key:str, td|None)) -> bytes
static PyObject *py_encode_frames(PyObject *self, PyObject *entries) {
    PyObject *seq = PySequence_Fast(entries, "entries not a sequence");
    if (!seq) return NULL;
    Wr w = {NULL, 0, 0, 0};
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *e = PySequence_Fast_GET_ITEM(seq, i);
        long op;
        PyObject *key, *td = Py_None;
        if (!PyArg_ParseTuple(e, "lU|O", &op, &key, &td)
                || !encode_frame_c(&w, op, key, td)) {
            free(w.b);
            Py_DECREF(seq);
            return NULL;
        }
    }
    Py_DECREF(seq);
    return wr_to_bytes(&w);
}

// encode_snapshot_body(iterable of (key:str, td)) -> bytes
static PyObject *py_encode_snapshot_body(PyObject *self, PyObject *items) {
    PyObject *seq = PySequence_Fast(items, "items not a sequence");
    if (!seq) return NULL;
    Wr w = {NULL, 0, 0, 0};
    Py_ssize_t n = PySequence_Fast_GET_SIZE(seq);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *e = PySequence_Fast_GET_ITEM(seq, i);
        PyObject *key, *td;
        if (!PyArg_ParseTuple(e, "UO", &key, &td)) {
            free(w.b);
            Py_DECREF(seq);
            return NULL;
        }
        size_t plen_at;
        uint32_t plen;
        if (!wr_pystr(&w, key) || !wr_u32(&w, 0)) goto fail;
        plen_at = w.len - 4;
        if (!encode_data_c(&w, td)) goto fail;
        plen = (uint32_t)(w.len - plen_at - 4);
        memcpy(w.b + plen_at, &plen, 4);
        continue;
    fail:
        free(w.b);
        Py_DECREF(seq);
        return NULL;
    }
    Py_DECREF(seq);
    return wr_to_bytes(&w);
}

// rows_from_columns(names, columns) -> list[dict]
// Builds row dicts from parallel column sequences at C speed — the
// hot materialization loop of joins and SELECT output. Matches the
// codegen'd dict-literal builder's zip semantics (shortest column
// bounds the row count).
static PyObject *py_rows_from_columns(PyObject *self, PyObject *args) {
    PyObject *names_o, *cols_o;
    if (!PyArg_ParseTuple(args, "OO", &names_o, &cols_o)) return NULL;
    PyObject *names = PySequence_Fast(names_o, "names not a sequence");
    if (!names) return NULL;
    PyObject *cols = PySequence_Fast(cols_o, "columns not a sequence");
    if (!cols) { Py_DECREF(names); return NULL; }
    Py_ssize_t k = PySequence_Fast_GET_SIZE(names);
    if (PySequence_Fast_GET_SIZE(cols) != k) {
        PyErr_SetString(PyExc_ValueError, "names/columns length mismatch");
        Py_DECREF(names);
        Py_DECREF(cols);
        return NULL;
    }
    PyObject **fast_cols =
        (PyObject **)PyMem_Malloc(sizeof(PyObject *) * (k ? k : 1));
    if (!fast_cols) {
        Py_DECREF(names);
        Py_DECREF(cols);
        return PyErr_NoMemory();
    }
    Py_ssize_t n = (k == 0) ? 0 : PY_SSIZE_T_MAX;
    Py_ssize_t made = 0;
    PyObject *out = NULL;
    for (Py_ssize_t j = 0; j < k; j++) {
        PyObject *f = PySequence_Fast(PySequence_Fast_GET_ITEM(cols, j),
                                      "column not a sequence");
        if (!f) goto done;
        fast_cols[j] = f;
        made++;
        Py_ssize_t len = PySequence_Fast_GET_SIZE(f);
        if (len < n) n = len;
    }
    out = PyList_New(n);
    if (!out) goto done;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *d = PyDict_New();
        if (!d) { Py_CLEAR(out); goto done; }
        for (Py_ssize_t j = 0; j < k; j++) {
            if (PyDict_SetItem(
                    d, PySequence_Fast_GET_ITEM(names, j),
                    PySequence_Fast_GET_ITEM(fast_cols[j], i)) != 0) {
                Py_DECREF(d);
                Py_CLEAR(out);
                goto done;
            }
        }
        PyList_SET_ITEM(out, i, d);
    }
done:
    for (Py_ssize_t j = 0; j < made; j++) Py_DECREF(fast_cols[j]);
    PyMem_Free(fast_cols);
    Py_DECREF(names);
    Py_DECREF(cols);
    return out;
}

#ifdef NEUMANN_DICT_INTERNALS
// Fill a clone of `tmpl` (small combined all-unicode table, k entries,
// placeholder values) by writing dk_entries directly. Steals the value
// references. Returns NULL with no error set when the clone has an
// unexpected shape (callers flip to the SetItem path).
static PyObject *clone_fill(PyObject *tmpl, PyObject **vals,
                            Py_ssize_t k) {
    PyObject *d = PyDict_Copy(tmpl);
    if (!d) return NULL;
    PyDictObject *mp = (PyDictObject *)d;
    _nc_dictkeys *dk = (_nc_dictkeys *)mp->ma_keys;
    if (mp->ma_values != NULL || dk->dk_kind != NC_DICT_KEYS_UNICODE ||
        dk->dk_nentries != k) {
        Py_DECREF(d);
        return NULL;
    }
    _nc_unicode_entry *ep = NC_DK_UNICODE_ENTRIES(dk);
    for (Py_ssize_t j = 0; j < k; j++) {
        PyObject *old = ep[j].me_value;
        ep[j].me_value = vals[j];
        Py_DECREF(old);
    }
    return d;
}

// Verify the layout assumptions against the running interpreter once.
static void dict_clone_selfcheck(void) {
    g_dict_clone_ok = 0;
    PyObject *tmpl = PyDict_New();
    if (!tmpl) { PyErr_Clear(); return; }
    if (PyDict_SetItemString(tmpl, "__nc_a", Py_None) != 0 ||
        PyDict_SetItemString(tmpl, "__nc_b", Py_None) != 0) {
        PyErr_Clear();
        Py_DECREF(tmpl);
        return;
    }
    PyObject *vals[2] = {PyLong_FromLong(11), PyLong_FromLong(22)};
    PyObject *d = (vals[0] && vals[1]) ? clone_fill(tmpl, vals, 2) : NULL;
    if (d) {
        PyObject *a = PyDict_GetItemString(d, "__nc_a");
        PyObject *b = PyDict_GetItemString(d, "__nc_b");
        if (a && b && PyLong_Check(a) && PyLong_Check(b) &&
            PyLong_AsLong(a) == 11 && PyLong_AsLong(b) == 22 &&
            PyDict_Size(d) == 2)
            g_dict_clone_ok = 1;
        Py_DECREF(d);
    } else {
        Py_XDECREF(vals[0]);
        Py_XDECREF(vals[1]);
    }
    PyErr_Clear();
    Py_DECREF(tmpl);
}
#endif

// rows_from_arrays(names, arrays, masks) -> list[dict]
// Column-to-row materialization straight from numpy buffers: values
// are boxed inline (no .tolist() intermediate lists), nulls come from
// optional per-column bool masks. Dtypes: int64, float64, bool,
// object. The hot loop of join/select output at 100K+ rows.
static PyObject *py_rows_from_arrays(PyObject *self, PyObject *args) {
    PyObject *names_o, *arrs_o, *masks_o;
    if (!PyArg_ParseTuple(args, "OOO", &names_o, &arrs_o, &masks_o))
        return NULL;
    PyObject *names = PySequence_Fast(names_o, "names not a sequence");
    if (!names) return NULL;
    PyObject *arrs = PySequence_Fast(arrs_o, "arrays not a sequence");
    if (!arrs) { Py_DECREF(names); return NULL; }
    PyObject *masks = PySequence_Fast(masks_o, "masks not a sequence");
    if (!masks) { Py_DECREF(names); Py_DECREF(arrs); return NULL; }
    Py_ssize_t k = PySequence_Fast_GET_SIZE(names);
    PyObject *out = NULL;
    struct Col {
        const char *data;
        npy_intp stride;
        int type;            // NPY_INT64 / NPY_FLOAT64 / NPY_BOOL / NPY_OBJECT
        const npy_bool *mask; // NULL -> no nulls
        npy_intp mask_stride;
        // run memo: join outputs repeat values in runs (each left row
        // fans out over its matches) — reuse the boxed object while
        // the 8-byte pattern repeats instead of re-allocating
        uint64_t prev_bits;
        PyObject *prev_obj;  // borrowed from the last row's dict
    };
    Col *cols = (Col *)PyMem_Malloc(sizeof(Col) * (k ? k : 1));
    PyObject **vals =
        (PyObject **)PyMem_Malloc(sizeof(PyObject *) * (k ? k : 1));
    PyObject *tmpl = NULL;
    if (!cols || !vals) { out = PyErr_NoMemory(); goto done; }
    {
        if (PySequence_Fast_GET_SIZE(arrs) != k ||
            PySequence_Fast_GET_SIZE(masks) != k) {
            PyErr_SetString(PyExc_ValueError, "names/arrays/masks mismatch");
            goto done;
        }
        Py_ssize_t n = (k == 0) ? 0 : PY_SSIZE_T_MAX;
        for (Py_ssize_t j = 0; j < k; j++) {
            PyObject *a = PySequence_Fast_GET_ITEM(arrs, j);
            if (!PyArray_Check(a)) {
                PyErr_SetString(PyExc_TypeError, "column not an ndarray");
                goto done;
            }
            PyArrayObject *arr = (PyArrayObject *)a;
            if (PyArray_NDIM(arr) != 1) {
                PyErr_SetString(PyExc_ValueError, "column not 1-D");
                goto done;
            }
            int t = PyArray_TYPE(arr);
            if (t != NPY_INT64 && t != NPY_FLOAT64 && t != NPY_BOOL &&
                t != NPY_OBJECT) {
                PyErr_SetString(PyExc_TypeError, "unsupported column dtype");
                goto done;
            }
            cols[j].data = (const char *)PyArray_DATA(arr);
            cols[j].stride = PyArray_STRIDE(arr, 0);
            cols[j].type = t;
            cols[j].mask = NULL;
            cols[j].mask_stride = 0;
            cols[j].prev_obj = NULL;
            cols[j].prev_bits = 0;
            if (PyArray_DIM(arr, 0) < n) n = PyArray_DIM(arr, 0);
            PyObject *m = PySequence_Fast_GET_ITEM(masks, j);
            if (m != Py_None) {
                if (!PyArray_Check(m) ||
                    PyArray_TYPE((PyArrayObject *)m) != NPY_BOOL ||
                    PyArray_NDIM((PyArrayObject *)m) != 1 ||
                    PyArray_DIM((PyArrayObject *)m, 0) <
                        PyArray_DIM(arr, 0)) {
                    PyErr_SetString(PyExc_ValueError, "bad null mask");
                    goto done;
                }
                cols[j].mask =
                    (const npy_bool *)PyArray_DATA((PyArrayObject *)m);
                cols[j].mask_stride =
                    PyArray_STRIDE((PyArrayObject *)m, 0);
            }
        }
        // Duplicate names make the run memo unsafe: a later SetItem
        // with the same key REPLACES (and may free) the earlier value
        // while cols[j].prev_obj still borrows it — the next row would
        // INCREF a dangling pointer. O(k^2) scan; k is column count.
        int memo_ok = 1;
        for (Py_ssize_t j = 1; memo_ok && j < k; j++)
            for (Py_ssize_t q = 0; q < j; q++) {
                int eq = PyObject_RichCompareBool(
                    PySequence_Fast_GET_ITEM(names, j),
                    PySequence_Fast_GET_ITEM(names, q), Py_EQ);
                if (eq < 0) goto done;
                if (eq) { memo_ok = 0; break; }
            }
        int use_clone = 0;
#ifdef NEUMANN_DICT_INTERNALS
        // Template-clone path: only when no object columns (so every
        // value is a non-GC-tracked int/float/bool/None and writing
        // entries directly can't hide a trackable object from the GC)
        if (g_dict_clone_ok && k > 0) {
            use_clone = 1;
            for (Py_ssize_t j = 0; j < k; j++)
                if (cols[j].type == NPY_OBJECT) { use_clone = 0; break; }
            if (use_clone) {
                tmpl = PyDict_New();
                if (!tmpl) { goto done; }
                for (Py_ssize_t j = 0; j < k; j++)
                    if (PyDict_SetItem(
                            tmpl, PySequence_Fast_GET_ITEM(names, j),
                            Py_None) != 0)
                        goto done;
                if (PyDict_Size(tmpl) != k)   // duplicate names
                    use_clone = 0;
            }
        }
#endif
        out = PyList_New(n);
        if (!out) goto done;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *d = NULL;
            if (!use_clone) {
                d = _PyDict_NewPresized(k);
                if (!d) { Py_CLEAR(out); goto done; }
            }
            for (Py_ssize_t j = 0; j < k; j++) {
                Col &c = cols[j];
                PyObject *v;
                if (c.mask &&
                    *(const npy_bool *)(((const char *)c.mask) +
                                        i * c.mask_stride)) {
                    v = Py_None;
                    Py_INCREF(v);
                    c.prev_obj = NULL;
                } else {
                    const char *p = c.data + i * c.stride;
                    switch (c.type) {
                    case NPY_INT64:
                    case NPY_FLOAT64: {
                        uint64_t bits;
                        memcpy(&bits, p, 8);
                        if (memo_ok && c.prev_obj && bits == c.prev_bits) {
                            v = c.prev_obj;
                            Py_INCREF(v);
                        } else {
                            if (c.type == NPY_INT64)
                                v = PyLong_FromLongLong((int64_t)bits);
                            else {
                                double x;
                                memcpy(&x, p, 8);
                                v = PyFloat_FromDouble(x);
                            }
                            c.prev_bits = bits;
                            c.prev_obj = v;   // borrowed: kept alive by
                        }                     // the row dict below
                        break;
                    }
                    case NPY_BOOL:
                        v = (*(const npy_bool *)p) ? Py_True : Py_False;
                        Py_INCREF(v);
                        break;
                    default: {  // NPY_OBJECT
                        memcpy(&v, p, sizeof(PyObject *));
                        if (!v) v = Py_None;
                        Py_INCREF(v);
                        break;
                    }
                    }
                }
                if (!v) {
                    if (use_clone)
                        for (Py_ssize_t q = 0; q < j; q++)
                            Py_DECREF(vals[q]);
                    else
                        Py_DECREF(d);
                    Py_CLEAR(out);
                    goto done;
                }
                if (use_clone) {
                    vals[j] = v;    // clone_fill steals these below
                    continue;
                }
                if (PyDict_SetItem(d, PySequence_Fast_GET_ITEM(names, j),
                                   v) != 0) {
                    Py_DECREF(v);
                    Py_DECREF(d);
                    Py_CLEAR(out);
                    goto done;
                }
                Py_DECREF(v);
            }
#ifdef NEUMANN_DICT_INTERNALS
            if (use_clone) {
                d = clone_fill(tmpl, vals, k);
                if (!d) {
                    for (Py_ssize_t q = 0; q < k; q++)
                        Py_DECREF(vals[q]);
                    if (!PyErr_Occurred()) {
                        // layout surprise: disable globally, redo this
                        // row through the SetItem path (memo objects
                        // were freed above, so reset it)
                        g_dict_clone_ok = 0;
                        use_clone = 0;
                        for (Py_ssize_t q = 0; q < k; q++)
                            cols[q].prev_obj = NULL;
                        i--;
                        continue;
                    }
                    Py_CLEAR(out);
                    goto done;
                }
            }
#endif
            PyList_SET_ITEM(out, i, d);
        }
    }
done:
    PyMem_Free(cols);
    PyMem_Free(vals);
    Py_XDECREF(tmpl);
    Py_DECREF(names);
    Py_DECREF(arrs);
    Py_DECREF(masks);
    return out;
}

// make_scalar(v) -> TensorValue("scalar", v) built at C speed —
// TensorValue.scalar routes here when the extension is loaded (the
// frozen-dataclass __init__ costs ~0.8us; this is ~0.15us).
static PyObject *py_make_scalar(PyObject *self, PyObject *v) {
    return make_tv(k_scalar, Py_NewRef(v));
}

// bulk_embed_entries(map, pending, prefix, keys, matrix, field_name)
// -> n.  Columnar-ingest helper: for each key build
// TensorData({field: TensorValue("vector", matrix[i])}) and insert it
// into the store map + pending-keys deque, all at C speed (the Python
// loop costs ~6.5 us/row; this is ~1.3 us). `matrix` is any sequence
// whose [i] yields the row (an ndarray view).
static PyObject *py_bulk_embed_entries(PyObject *self, PyObject *args) {
    PyObject *map, *pending, *prefix, *keys, *matrix, *field;
    if (!PyArg_ParseTuple(args, "OOUOOU", &map, &pending, &prefix,
                          &keys, &matrix, &field))
        return NULL;
    if (!PyDict_Check(map) || !PyList_Check(keys)) {
        PyErr_SetString(PyExc_TypeError,
                        "map must be dict, keys must be list");
        return NULL;
    }
    PyObject *s_append = PyUnicode_InternFromString("append");
    if (!s_append) return NULL;
    PyObject *append = PyObject_GetAttr(pending, s_append);
    Py_DECREF(s_append);
    if (!append) return NULL;
    Py_ssize_t n = PyList_GET_SIZE(keys);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *full = PyUnicode_Concat(prefix,
                                          PyList_GET_ITEM(keys, i));
        if (!full) { Py_DECREF(append); return NULL; }
        PyObject *row = PySequence_GetItem(matrix, i);
        PyObject *tv = make_tv(k_vector, row);       // steals row
        if (!tv) { Py_DECREF(full); Py_DECREF(append); return NULL; }
        PyObject *fields = PyDict_New();
        if (!fields || PyDict_SetItem(fields, field, tv) != 0) {
            Py_XDECREF(fields); Py_DECREF(tv); Py_DECREF(full);
            Py_DECREF(append);
            return NULL;
        }
        Py_DECREF(tv);
        PyObject *td = make_td(fields);              // steals fields
        if (!td || PyDict_SetItem(map, full, td) != 0) {
            Py_XDECREF(td); Py_DECREF(full); Py_DECREF(append);
            return NULL;
        }
        Py_DECREF(td);
        PyObject *r = PyObject_CallOneArg(append, full);
        Py_DECREF(full);
        if (!r) { Py_DECREF(append); return NULL; }
        Py_DECREF(r);
    }
    Py_DECREF(append);
    return PyLong_FromSsize_t(n);
}

// wal_walk_floor(buf[, lazy]) -> n_records.  The replay FLOOR probe:
// walks the frame chain and CRC-verifies payloads exactly like
// wal_overlay's parse, but performs NO hashing and NO map upserts.
// Replay rate vs this rate attributes the map's cost; this rate vs
// memory bandwidth attributes the CRC+walk floor (the round-3 ask:
// cross 20M rec/s or prove the floor with numbers).
static PyObject *py_wal_walk_floor(PyObject *self, PyObject *args) {
    PyObject *bufobj;
    int lazy = 0;
    if (!PyArg_ParseTuple(args, "O|i", &bufobj, &lazy)) return NULL;
    Py_buffer view;
    if (PyObject_GetBuffer(bufobj, &view, PyBUF_SIMPLE) < 0)
        return NULL;
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len, pos = 0;
    long n = 0;
    volatile uint32_t sink = 0;    // keep the CRC from being elided
    while (pos + 8 <= len) {
        uint32_t flen, crc;
        memcpy(&flen, buf + pos, 4);
        memcpy(&crc, buf + pos + 4, 4);
        if ((Py_ssize_t)flen > len - pos - 8) break;
        const unsigned char *payload = buf + pos + 8;
        if (!lazy && fast_crc(payload, flen) != crc) break;
        if (flen < 5) break;
        uint32_t klen;
        memcpy(&klen, payload + 1, 4);
        sink ^= klen ^ payload[0];
        n++;
        pos += 8 + (Py_ssize_t)flen;
    }
    (void)sink;
    PyBuffer_Release(&view);
    return PyLong_FromLong(n);
}

// ---- init -------------------------------------------------------------

static PyObject *py_init(PyObject *self, PyObject *args) {
    PyObject *tv, *td, *vfb, *sfp, *afb, *sp;
    if (!PyArg_ParseTuple(args, "OOOOOO", &tv, &td, &vfb, &sfp, &afb,
                          &sp))
        return NULL;
    Py_XSETREF(g_tv_cls, Py_NewRef(tv));
    Py_XSETREF(g_td_cls, Py_NewRef(td));
    // cache slot member descriptors when the classes define __slots__;
    // a data descriptor on the class named like the field IS the slot
    Py_CLEAR(d_kind); Py_CLEAR(d_value); Py_CLEAR(d_fields);
    PyObject *descr = PyObject_GetAttr(tv, s_kind);
    if (descr && Py_TYPE(descr)->tp_descr_set) d_kind = descr;
    else { Py_XDECREF(descr); PyErr_Clear(); }
    descr = PyObject_GetAttr(tv, s_value);
    if (descr && Py_TYPE(descr)->tp_descr_set) d_value = descr;
    else { Py_XDECREF(descr); PyErr_Clear(); }
    descr = PyObject_GetAttr(td, s_fields);
    if (descr && Py_TYPE(descr)->tp_descr_set) d_fields = descr;
    else { Py_XDECREF(descr); PyErr_Clear(); }
    Py_XSETREF(g_vec_from_bytes, Py_NewRef(vfb));
    Py_XSETREF(g_sparse_from_parts, Py_NewRef(sfp));
    Py_XSETREF(g_as_f4_bytes, Py_NewRef(afb));
    Py_XSETREF(g_sparse_parts, Py_NewRef(sp));
#ifdef NEUMANN_DICT_INTERNALS
    dict_clone_selfcheck();
#endif
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"init", py_init, METH_VARARGS,
     "init(TensorValue, TensorData, vec_from_bytes, sparse_from_parts, "
     "as_f4_bytes, sparse_parts)"},
    {"decode_data", py_decode_data, METH_VARARGS, NULL},
    {"decode_wal", py_decode_wal, METH_VARARGS, NULL},
    {"wal_apply", py_wal_apply, METH_VARARGS, NULL},
    {"wal_overlay", py_wal_overlay, METH_VARARGS, NULL},
    {"snapshot_lazy", py_snapshot_lazy, METH_VARARGS, NULL},
    {"overlay_pop", py_overlay_pop, METH_VARARGS, NULL},
    {"overlay_keys", py_overlay_keys, METH_VARARGS, NULL},
    {"overlay_count", py_overlay_count, METH_VARARGS, NULL},
    {"crc_fast_ok", py_crc_fast_ok, METH_NOARGS, NULL},
    {"overlay_tombstones", py_overlay_tombstones, METH_VARARGS, NULL},
    {"decode_snapshot_body", py_decode_snapshot_body, METH_VARARGS, NULL},
    {"encode_data", py_encode_data, METH_O, NULL},
    {"encode_frame", (PyCFunction)(void (*)(void))py_encode_frame,
     METH_FASTCALL, NULL},
    {"framebuf_new", py_framebuf_new, METH_NOARGS, NULL},
    {"framebuf_append", (PyCFunction)(void (*)(void))py_framebuf_append,
     METH_FASTCALL, NULL},
    {"framebuf_take", py_framebuf_take, METH_VARARGS, NULL},
    {"encode_frames", py_encode_frames, METH_O, NULL},
    {"encode_snapshot_body", py_encode_snapshot_body, METH_O, NULL},
    {"rows_from_columns", py_rows_from_columns, METH_VARARGS, NULL},
    {"rows_from_arrays", py_rows_from_arrays, METH_VARARGS, NULL},
    {"make_scalar", py_make_scalar, METH_O, NULL},
    {"bulk_embed_entries", py_bulk_embed_entries, METH_VARARGS, NULL},
    {"wal_walk_floor", py_wal_walk_floor, METH_VARARGS, NULL},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_neumann_codec",
    "Native binary codec for the tensor store (WAL + snapshots).",
    -1, methods,
};

extern "C" PyMODINIT_FUNC PyInit__neumann_codec(void) {
    import_array();
    s16_init();
    s_kind = PyUnicode_InternFromString("kind");
    s_value = PyUnicode_InternFromString("value");
    s_fields = PyUnicode_InternFromString("fields");
    k_scalar = PyUnicode_InternFromString("scalar");
    k_vector = PyUnicode_InternFromString("vector");
    k_sparse = PyUnicode_InternFromString("sparse");
    k_pointer = PyUnicode_InternFromString("pointer");
    k_pointers = PyUnicode_InternFromString("pointers");
    s_put = PyUnicode_InternFromString("put");
    s_delete = PyUnicode_InternFromString("delete");
    return PyModule_Create(&moddef);
}
