// Native proto codec for the binary PointsService serving data plane.
//
// The GIL-bound Python protobuf path costs ~1.5 ms/query of response
// marshaling at serving load (BENCHMARKS.md r4); this extension
// encodes/decodes the four hot messages (QueryPointsRequest/Response,
// both directions) as flat byte passes, so the gRPC handler runs with
// raw-bytes (de)serializers and never touches a Python pb object.
// Wire format identical to neumann.proto (checked against protoc in
// tests/test_points_codec.py). Capability parity target: the
// reference's tonic zero-alloc handler path
// (neumann_server/src/service/query.rs:207-278, proto/vector.proto).
//
// Exposed functions:
//   parse_query(bytes)  -> (collection, vec_f4_bytes, limit,
//                           filter_json|None, with_payload, metric|None,
//                           req_id)
//   encode_query(collection, vec_buffer_f4, limit, filter_json|None,
//                with_payload, metric|None, req_id) -> bytes
//   parse_response(bytes) -> (req_id, [ids], scores_f4_bytes,
//                             [payloads]|None, error|None)
//   encode_response(req_id, [ids], scores_buffer_f4,
//                   [payloads]|None, error|None) -> bytes

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------- varint --
inline size_t varint_size(uint64_t v) {
  size_t n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

inline uint8_t* put_varint(uint8_t* p, uint64_t v) {
  while (v >= 0x80) { *p++ = uint8_t(v) | 0x80; v >>= 7; }
  *p++ = uint8_t(v);
  return p;
}

// returns false on truncation
inline bool get_varint(const uint8_t*& p, const uint8_t* end,
                       uint64_t* out) {
  uint64_t v = 0;
  int shift = 0;
  while (p < end && shift < 64) {
    uint8_t b = *p++;
    v |= uint64_t(b & 0x7f) << shift;
    if (!(b & 0x80)) { *out = v; return true; }
    shift += 7;
  }
  return false;
}

inline bool skip_field(const uint8_t*& p, const uint8_t* end,
                       uint32_t wire) {
  uint64_t tmp;
  switch (wire) {
    case 0: return get_varint(p, end, &tmp);
    case 1: if (end - p < 8) return false; p += 8; return true;
    case 2:
      if (!get_varint(p, end, &tmp) || uint64_t(end - p) < tmp)
        return false;
      p += tmp; return true;
    case 5: if (end - p < 4) return false; p += 4; return true;
    default: return false;
  }
}

struct Slice { const uint8_t* p = nullptr; size_t n = 0; };

PyObject* str_or_none(const Slice& s) {
  if (s.n == 0) Py_RETURN_NONE;
  return PyUnicode_DecodeUTF8(reinterpret_cast<const char*>(s.p),
                              Py_ssize_t(s.n), "strict");
}

// ------------------------------------------------------------ parse_query --
// QueryPointsRequest: 1 collection, 2 vector (packed f32 or repeated
// fixed32), 3 limit, 4 filter_json, 5 with_payload, 6 metric, 15 req_id
PyObject* parse_query(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  const uint8_t* p = static_cast<const uint8_t*>(buf.buf);
  const uint8_t* end = p + buf.len;

  Slice collection, filter_json, metric, packed_vec;
  std::vector<uint8_t> loose_vec;   // unpacked `repeated float` form
  int64_t limit = 0;
  uint64_t req_id = 0;
  int with_payload = 0;
  bool ok = true;

  while (p < end && ok) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) { ok = false; break; }
    uint32_t fieldno = uint32_t(tag >> 3), wire = uint32_t(tag & 7);
    uint64_t len, v;
    switch (fieldno) {
      case 1: case 4: case 6: {
        if (wire != 2 || !get_varint(p, end, &len) ||
            uint64_t(end - p) < len) { ok = false; break; }
        Slice s{p, size_t(len)};
        if (fieldno == 1) collection = s;
        else if (fieldno == 4) filter_json = s;
        else metric = s;
        p += len;
        break;
      }
      case 2:
        if (wire == 2) {            // packed (proto3 default)
          if (!get_varint(p, end, &len) || uint64_t(end - p) < len ||
              (len & 3)) { ok = false; break; }
          packed_vec = {p, size_t(len)};
          p += len;
        } else if (wire == 5) {     // unpacked singleton(s)
          if (end - p < 4) { ok = false; break; }
          loose_vec.insert(loose_vec.end(), p, p + 4);
          p += 4;
        } else ok = skip_field(p, end, wire);
        break;
      case 3:
        if (wire != 0 || !get_varint(p, end, &v)) { ok = false; break; }
        limit = int64_t(v);
        break;
      case 5:
        if (wire != 0 || !get_varint(p, end, &v)) { ok = false; break; }
        with_payload = v != 0;
        break;
      case 15:
        if (wire != 0 || !get_varint(p, end, &req_id)) ok = false;
        break;
      default:
        ok = skip_field(p, end, wire);
    }
  }
  if (!ok) {
    PyBuffer_Release(&buf);
    PyErr_SetString(PyExc_ValueError, "malformed QueryPointsRequest");
    return nullptr;
  }

  PyObject* vec;
  if (packed_vec.n)
    vec = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(packed_vec.p),
        Py_ssize_t(packed_vec.n));
  else
    vec = PyBytes_FromStringAndSize(
        reinterpret_cast<const char*>(loose_vec.data()),
        Py_ssize_t(loose_vec.size()));

  PyObject* out = Py_BuildValue(
      "(s#NLNNNK)",
      reinterpret_cast<const char*>(collection.p ? collection.p
                                    : reinterpret_cast<const uint8_t*>("")),
      Py_ssize_t(collection.n),
      vec,
      static_cast<long long>(limit),
      str_or_none(filter_json),
      PyBool_FromLong(with_payload),
      str_or_none(metric),
      static_cast<unsigned long long>(req_id));
  PyBuffer_Release(&buf);
  return out;
}

// ----------------------------------------------------------- encode_query --
PyObject* encode_query(PyObject*, PyObject* args) {
  const char* collection; Py_ssize_t col_n;
  Py_buffer vec;
  long long limit;
  PyObject* filter_obj;
  int with_payload;
  PyObject* metric_obj;
  unsigned long long req_id;
  if (!PyArg_ParseTuple(args, "s#y*LOpOK", &collection, &col_n, &vec,
                        &limit, &filter_obj, &with_payload, &metric_obj,
                        &req_id))
    return nullptr;
  if (vec.len & 3) {
    PyBuffer_Release(&vec);
    PyErr_SetString(PyExc_ValueError, "vector buffer not f32-aligned");
    return nullptr;
  }
  const char* filter = nullptr; Py_ssize_t filter_n = 0;
  const char* metric = nullptr; Py_ssize_t metric_n = 0;
  if (filter_obj != Py_None &&
      (filter = PyUnicode_AsUTF8AndSize(filter_obj, &filter_n)) == nullptr) {
    PyBuffer_Release(&vec); return nullptr;
  }
  if (metric_obj != Py_None &&
      (metric = PyUnicode_AsUTF8AndSize(metric_obj, &metric_n)) == nullptr) {
    PyBuffer_Release(&vec); return nullptr;
  }

  size_t bound = 2 + varint_size(col_n) + size_t(col_n) +
                 2 + varint_size(vec.len) + size_t(vec.len) +
                 2 + 10 +                       // limit
                 2 + varint_size(filter_n) + size_t(filter_n) +
                 2 +                            // with_payload
                 2 + varint_size(metric_n) + size_t(metric_n) +
                 2 + 10;                        // req_id
  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(bound));
  if (!out) { PyBuffer_Release(&vec); return nullptr; }
  uint8_t* w = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  uint8_t* w0 = w;
  if (col_n) {
    *w++ = 0x0a; w = put_varint(w, uint64_t(col_n));
    std::memcpy(w, collection, size_t(col_n)); w += col_n;
  }
  if (vec.len) {
    *w++ = 0x12; w = put_varint(w, uint64_t(vec.len));
    std::memcpy(w, vec.buf, size_t(vec.len)); w += vec.len;
  }
  if (limit) { *w++ = 0x18; w = put_varint(w, uint64_t(limit)); }
  if (filter_n) {
    *w++ = 0x22; w = put_varint(w, uint64_t(filter_n));
    std::memcpy(w, filter, size_t(filter_n)); w += filter_n;
  }
  if (with_payload) { *w++ = 0x28; *w++ = 1; }
  if (metric_n) {
    *w++ = 0x32; w = put_varint(w, uint64_t(metric_n));
    std::memcpy(w, metric, size_t(metric_n)); w += metric_n;
  }
  if (req_id) { *w++ = 0x78; w = put_varint(w, req_id); }
  PyBuffer_Release(&vec);
  if (_PyBytes_Resize(&out, Py_ssize_t(w - w0)) != 0) return nullptr;
  return out;
}

// -------------------------------------------------------- encode_response --
// QueryPointsResponse: 1 repeated ScoredPoint{1 id, 2 score, 3 payload},
// 2 error, 15 req_id
PyObject* encode_response(PyObject*, PyObject* args) {
  unsigned long long req_id;
  PyObject* ids;
  Py_buffer scores;
  PyObject* payloads;
  PyObject* error_obj;
  if (!PyArg_ParseTuple(args, "KOy*OO", &req_id, &ids, &scores,
                        &payloads, &error_obj))
    return nullptr;
  if (!PyList_Check(ids)) {
    PyBuffer_Release(&scores);
    PyErr_SetString(PyExc_TypeError, "ids must be a list");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(ids);
  if (scores.len != n * Py_ssize_t(sizeof(float))) {
    PyBuffer_Release(&scores);
    PyErr_SetString(PyExc_ValueError, "scores length != 4*len(ids)");
    return nullptr;
  }
  bool with_payload = payloads != Py_None;
  if (with_payload &&
      (!PyList_Check(payloads) || PyList_GET_SIZE(payloads) != n)) {
    PyBuffer_Release(&scores);
    PyErr_SetString(PyExc_ValueError, "payloads must match ids");
    return nullptr;
  }
  const char* error = nullptr; Py_ssize_t error_n = 0;
  if (error_obj != Py_None &&
      (error = PyUnicode_AsUTF8AndSize(error_obj, &error_n)) == nullptr) {
    PyBuffer_Release(&scores); return nullptr;
  }

  // collect utf8 views first (also computes exact sizes)
  const size_t un = static_cast<size_t>(n);
  std::vector<const char*> id_p(un, nullptr), pl_p(un, nullptr);
  std::vector<Py_ssize_t> id_n(un, 0), pl_n(un, 0);
  size_t bound = 2 + 10;                      // req_id
  for (Py_ssize_t i = 0; i < n; ++i) {
    id_p[size_t(i)] = PyUnicode_AsUTF8AndSize(PyList_GET_ITEM(ids, i),
                                              &id_n[size_t(i)]);
    if (!id_p[size_t(i)]) { PyBuffer_Release(&scores); return nullptr; }
    if (with_payload) {
      PyObject* pl = PyList_GET_ITEM(payloads, i);
      if (pl != Py_None) {
        pl_p[size_t(i)] = PyUnicode_AsUTF8AndSize(pl, &pl_n[size_t(i)]);
        if (!pl_p[size_t(i)]) { PyBuffer_Release(&scores); return nullptr; }
      }
    }
    bound += 2 + 5 +                          // submsg tag+len
             2 + varint_size(uint64_t(id_n[size_t(i)])) +
             size_t(id_n[size_t(i)]) + 5 +    // score
             2 + varint_size(uint64_t(pl_n[size_t(i)])) +
             size_t(pl_n[size_t(i)]);
  }
  bound += 2 + varint_size(uint64_t(error_n)) + size_t(error_n);

  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(bound));
  if (!out) { PyBuffer_Release(&scores); return nullptr; }
  uint8_t* w = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  uint8_t* w0 = w;
  const uint8_t* sc = static_cast<const uint8_t*>(scores.buf);
  for (Py_ssize_t i = 0; i < n; ++i) {
    size_t inner = 1 + varint_size(uint64_t(id_n[size_t(i)])) +
                   size_t(id_n[size_t(i)]) + 5;
    if (pl_n[size_t(i)])
      inner += 1 + varint_size(uint64_t(pl_n[size_t(i)])) +
               size_t(pl_n[size_t(i)]);
    *w++ = 0x0a; w = put_varint(w, inner);
    *w++ = 0x0a; w = put_varint(w, uint64_t(id_n[size_t(i)]));
    std::memcpy(w, id_p[size_t(i)], size_t(id_n[size_t(i)]));
    w += id_n[size_t(i)];
    *w++ = 0x15;
    std::memcpy(w, sc + 4 * i, 4); w += 4;
    if (pl_n[size_t(i)]) {
      *w++ = 0x1a; w = put_varint(w, uint64_t(pl_n[size_t(i)]));
      std::memcpy(w, pl_p[size_t(i)], size_t(pl_n[size_t(i)]));
      w += pl_n[size_t(i)];
    }
  }
  if (error_n) {
    *w++ = 0x12; w = put_varint(w, uint64_t(error_n));
    std::memcpy(w, error, size_t(error_n)); w += error_n;
  }
  if (req_id) { *w++ = 0x78; w = put_varint(w, req_id); }
  PyBuffer_Release(&scores);
  if (_PyBytes_Resize(&out, Py_ssize_t(w - w0)) != 0) return nullptr;
  return out;
}

// --------------------------------------------------------- parse_response --
PyObject* parse_response(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  const uint8_t* p = static_cast<const uint8_t*>(buf.buf);
  const uint8_t* end = p + buf.len;

  PyObject* ids = PyList_New(0);
  PyObject* payloads = PyList_New(0);
  std::vector<uint8_t> scores;
  Slice error;
  uint64_t req_id = 0;
  bool ok = ids && payloads;
  bool any_payload = false;

  while (ok && p < end) {
    uint64_t tag;
    if (!get_varint(p, end, &tag)) { ok = false; break; }
    uint32_t fieldno = uint32_t(tag >> 3), wire = uint32_t(tag & 7);
    uint64_t len;
    if (fieldno == 1 && wire == 2) {
      if (!get_varint(p, end, &len) || uint64_t(end - p) < len) {
        ok = false; break;
      }
      const uint8_t* q = p;
      const uint8_t* qend = p + len;
      p = qend;
      Slice id, payload;
      float score = 0.0f;
      while (q < qend) {
        uint64_t t2;
        if (!get_varint(q, qend, &t2)) { ok = false; break; }
        uint32_t f2 = uint32_t(t2 >> 3), w2 = uint32_t(t2 & 7);
        uint64_t l2;
        if (f2 == 1 && w2 == 2) {
          if (!get_varint(q, qend, &l2) || uint64_t(qend - q) < l2) {
            ok = false; break;
          }
          id = {q, size_t(l2)}; q += l2;
        } else if (f2 == 2 && w2 == 5) {
          if (qend - q < 4) { ok = false; break; }
          std::memcpy(&score, q, 4); q += 4;
        } else if (f2 == 3 && w2 == 2) {
          if (!get_varint(q, qend, &l2) || uint64_t(qend - q) < l2) {
            ok = false; break;
          }
          payload = {q, size_t(l2)}; q += l2;
        } else if (!skip_field(q, qend, w2)) { ok = false; break; }
      }
      if (!ok) break;
      PyObject* ido = PyUnicode_DecodeUTF8(
          reinterpret_cast<const char*>(id.p), Py_ssize_t(id.n),
          "strict");
      if (!ido || PyList_Append(ids, ido) != 0) {
        Py_XDECREF(ido); ok = false; break;
      }
      Py_DECREF(ido);
      PyObject* plo = str_or_none(payload);
      if (payload.n) any_payload = true;
      if (!plo || PyList_Append(payloads, plo) != 0) {
        Py_XDECREF(plo); ok = false; break;
      }
      Py_DECREF(plo);
      const uint8_t* sp = reinterpret_cast<const uint8_t*>(&score);
      scores.insert(scores.end(), sp, sp + 4);
    } else if (fieldno == 2 && wire == 2) {
      if (!get_varint(p, end, &len) || uint64_t(end - p) < len) {
        ok = false; break;
      }
      error = {p, size_t(len)}; p += len;
    } else if (fieldno == 15 && wire == 0) {
      if (!get_varint(p, end, &req_id)) { ok = false; break; }
    } else if (!skip_field(p, end, wire)) { ok = false; break; }
  }
  PyBuffer_Release(&buf);
  if (!ok) {
    Py_XDECREF(ids); Py_XDECREF(payloads);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "malformed QueryPointsResponse");
    return nullptr;
  }
  PyObject* pls;
  if (any_payload) { pls = payloads; }
  else { Py_DECREF(payloads); pls = Py_None; Py_INCREF(pls); }
  PyObject* sc = PyBytes_FromStringAndSize(
      reinterpret_cast<const char*>(scores.data()),
      Py_ssize_t(scores.size()));
  PyObject* out = Py_BuildValue("(KNNNN)",
                                static_cast<unsigned long long>(req_id),
                                ids, sc, pls, str_or_none(error));
  return out;
}

// --------------------------------------------------------- split / join --
// QueryPointsBatch{Request,Response} are just `repeated <msg> = 1`;
// these two generic helpers (de)frame the submessages so the batch
// path composes with the per-message codec above.
PyObject* split_messages(PyObject*, PyObject* arg) {
  Py_buffer buf;
  if (PyObject_GetBuffer(arg, &buf, PyBUF_SIMPLE) != 0) return nullptr;
  const uint8_t* p = static_cast<const uint8_t*>(buf.buf);
  const uint8_t* end = p + buf.len;
  PyObject* out = PyList_New(0);
  bool ok = out != nullptr;
  while (ok && p < end) {
    uint64_t tag, len;
    if (!get_varint(p, end, &tag)) { ok = false; break; }
    if ((tag >> 3) == 1 && (tag & 7) == 2) {
      if (!get_varint(p, end, &len) || uint64_t(end - p) < len) {
        ok = false; break;
      }
      PyObject* sub = PyBytes_FromStringAndSize(
          reinterpret_cast<const char*>(p), Py_ssize_t(len));
      if (!sub || PyList_Append(out, sub) != 0) {
        Py_XDECREF(sub); ok = false; break;
      }
      Py_DECREF(sub);
      p += len;
    } else if (!skip_field(p, end, uint32_t(tag & 7))) {
      ok = false; break;
    }
  }
  PyBuffer_Release(&buf);
  if (!ok) {
    Py_XDECREF(out);
    if (!PyErr_Occurred())
      PyErr_SetString(PyExc_ValueError, "malformed batch message");
    return nullptr;
  }
  return out;
}

PyObject* join_messages(PyObject*, PyObject* arg) {
  if (!PyList_Check(arg)) {
    PyErr_SetString(PyExc_TypeError, "expected list of bytes");
    return nullptr;
  }
  Py_ssize_t n = PyList_GET_SIZE(arg);
  size_t total = 0;
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* it = PyList_GET_ITEM(arg, i);
    if (!PyBytes_Check(it)) {
      PyErr_SetString(PyExc_TypeError, "expected list of bytes");
      return nullptr;
    }
    size_t ln = size_t(PyBytes_GET_SIZE(it));
    total += 1 + varint_size(ln) + ln;
  }
  PyObject* out = PyBytes_FromStringAndSize(nullptr, Py_ssize_t(total));
  if (!out) return nullptr;
  uint8_t* w = reinterpret_cast<uint8_t*>(PyBytes_AS_STRING(out));
  for (Py_ssize_t i = 0; i < n; ++i) {
    PyObject* it = PyList_GET_ITEM(arg, i);
    size_t ln = size_t(PyBytes_GET_SIZE(it));
    *w++ = 0x0a;
    w = put_varint(w, ln);
    std::memcpy(w, PyBytes_AS_STRING(it), ln);
    w += ln;
  }
  return out;
}

PyMethodDef methods[] = {
    {"parse_query", parse_query, METH_O,
     "parse QueryPointsRequest bytes"},
    {"encode_query", encode_query, METH_VARARGS,
     "encode QueryPointsRequest"},
    {"parse_response", parse_response, METH_O,
     "parse QueryPointsResponse bytes"},
    {"encode_response", encode_response, METH_VARARGS,
     "encode QueryPointsResponse"},
    {"split_messages", split_messages, METH_O,
     "split `repeated <msg> = 1` batch bytes into submessage list"},
    {"join_messages", join_messages, METH_O,
     "frame a list of submessage bytes as `repeated <msg> = 1`"},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_neumann_points",
                         "native PointsService proto codec", -1, methods,
                         nullptr, nullptr, nullptr, nullptr};

}  // namespace

PyMODINIT_FUNC PyInit__neumann_points(void) {
  return PyModule_Create(&moduledef);
}
