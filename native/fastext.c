/* CPython extension for batch line materialization.
 *
 * The Reader's extraction pipeline resolves hits to deduplicated line ids
 * with vectorized numpy (ops/extract.py); what remains — decoding each
 * distinct line to str and fanning the objects out into per-query lists —
 * is object-creation work the interpreter does at ~0.3 M lines/s in a
 * comprehension.  This module does the same at C speed (PyUnicode decode +
 * borrowed-reference fan-out), the role PyO3's Vec<&str> -> list conversion
 * plays in the reference (src/lib.rs:275, 284-287).
 *
 * materialize(data, starts, ends, inv, gstart, gstop, qid) -> dict
 *   data:   buffer, the chunk text
 *   starts: int64[D] line start offsets   (distinct lines)
 *   ends:   int64[D] line end offsets (exclusive)
 *   inv:    int64[T] entry -> distinct-line index, grouped by query
 *   gstart: int64[G] group start in inv   gstop: int64[G] group end
 *   qid:    int64[G] query id per group
 * Returns {qid: [str, ...]} with lines decoded utf-8/surrogateescape
 * (lossless for arbitrary bytes — the analogue of the reference's
 * from_utf8_unchecked).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>

/* Decode one line span to str: ASCII fast path (the overwhelming case for
 * the reference's word corpora) allocates the 1-byte-kind unicode directly
 * and copies while checking the high bits word-at-a-time; any non-ASCII
 * byte discards and falls back to the full UTF-8 decoder.  ~40 ns cheaper
 * per line than PyUnicode_DecodeUTF8's generic entry at typical line
 * lengths. */
static inline PyObject* decode_line(const char* base, int64_t s, int64_t e) {
  Py_ssize_t len = (Py_ssize_t)(e - s);
  const unsigned char* p = (const unsigned char*)(base + s);
  PyObject* obj = PyUnicode_New(len, 127);
  if (obj != NULL) {
    unsigned char* dst = (unsigned char*)PyUnicode_1BYTE_DATA(obj);
    Py_ssize_t i = 0;
    uint64_t acc = 0;
    for (; i + 8 <= len; i += 8) {
      uint64_t w;
      memcpy(&w, p + i, 8);
      acc |= w;
      memcpy(dst + i, &w, 8);
    }
    for (; i < len; ++i) {
      acc |= p[i];
      dst[i] = p[i];
    }
    if ((acc & 0x8080808080808080ull) == 0) return obj;
    Py_DECREF(obj); /* non-ASCII: take the full decoder */
  } else {
    PyErr_Clear();
  }
  return PyUnicode_DecodeUTF8(base + s, len, "surrogateescape");
}

static PyObject* materialize(PyObject* self, PyObject* args) {
  Py_buffer data, bstarts, bends, binv, bgstart, bgstop, bqid;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*y*", &data, &bstarts, &bends,
                        &binv, &bgstart, &bgstop, &bqid))
    return NULL;
  PyObject* out = NULL;
  PyObject** dist = NULL;
  const char* base = (const char*)data.buf;
  const int64_t* starts = (const int64_t*)bstarts.buf;
  const int64_t* ends = (const int64_t*)bends.buf;
  const int64_t* inv = (const int64_t*)binv.buf;
  const int64_t* gstart = (const int64_t*)bgstart.buf;
  const int64_t* gstop = (const int64_t*)bgstop.buf;
  const int64_t* qid = (const int64_t*)bqid.buf;
  Py_ssize_t D = bstarts.len / 8;
  Py_ssize_t T = binv.len / 8;
  Py_ssize_t G = bgstart.len / 8;
  Py_ssize_t d = 0;
  if (bends.len / 8 != D || bgstop.len / 8 != G || bqid.len / 8 != G) {
    PyErr_SetString(PyExc_ValueError, "materialize: length mismatch");
    goto done;
  }
  dist = (PyObject**)PyMem_Malloc((size_t)(D > 0 ? D : 1) * sizeof(void*));
  if (dist == NULL) {
    PyErr_NoMemory();
    goto done;
  }
  for (d = 0; d < D; ++d) {
    int64_t s = starts[d], e = ends[d];
    if (d + 8 < D) __builtin_prefetch(base + starts[d + 8]);
    if (s < 0 || e < s || e > (int64_t)data.len) {
      PyErr_SetString(PyExc_ValueError, "materialize: span out of bounds");
      goto done;
    }
    dist[d] = decode_line(base, s, e);
    if (dist[d] == NULL) goto done;
  }
  out = PyDict_New();
  if (out == NULL) goto done;
  for (Py_ssize_t g = 0; g < G; ++g) {
    int64_t a = gstart[g], b = gstop[g];
    if (a < 0 || b < a || b > (int64_t)T) {
      PyErr_SetString(PyExc_ValueError, "materialize: group out of bounds");
      Py_CLEAR(out);
      goto done;
    }
    PyObject* lst = PyList_New((Py_ssize_t)(b - a));
    if (lst == NULL) {
      Py_CLEAR(out);
      goto done;
    }
    for (int64_t t = a; t < b; ++t) {
      int64_t ix = inv[t];
      if (ix < 0 || ix >= (int64_t)D) {
        PyErr_SetString(PyExc_ValueError, "materialize: inv out of bounds");
        Py_DECREF(lst);
        Py_CLEAR(out);
        goto done;
      }
      PyObject* s = dist[ix];
      Py_INCREF(s);
      PyList_SET_ITEM(lst, (Py_ssize_t)(t - a), s);
    }
    PyObject* key = PyLong_FromLongLong(qid[g]);
    int rc = key == NULL ? -1 : PyDict_SetItem(out, key, lst);
    Py_XDECREF(key);
    Py_DECREF(lst);
    if (rc != 0) {
      Py_CLEAR(out);
      goto done;
    }
  }
done:
  if (dist != NULL) {
    for (Py_ssize_t i = 0; i < d; ++i) Py_XDECREF(dist[i]);
    PyMem_Free(dist);
  }
  PyBuffer_Release(&data);
  PyBuffer_Release(&bstarts);
  PyBuffer_Release(&bends);
  PyBuffer_Release(&binv);
  PyBuffer_Release(&bgstart);
  PyBuffer_Release(&bgstop);
  PyBuffer_Release(&bqid);
  return out;
}

/* materialize_dedup(data, starts, ends, gstart, gstop, qid) -> dict
 *
 * Like materialize, but the entries are raw per-occurrence spans (one per
 * (query, line) hit, possibly repeating the same line across queries) and
 * the distinct-decode map is built HERE with an open-addressing hash on the
 * line-start offset — each distinct line is decoded exactly once per call,
 * every repeat is a pointer INCREF.  Replaces a numpy-side
 * unique+inverse whose 22M-entry argsort measured ~8 s; the hash pass is
 * a single sweep.  Groups must cover entries back to back (gstart[g] ==
 * gstop[g-1]); spans inside a group keep their given order.
 */
static PyObject* materialize_dedup(PyObject* self, PyObject* args) {
  Py_buffer data, bstarts, bends, bgstart, bgstop, bqid;
  if (!PyArg_ParseTuple(args, "y*y*y*y*y*y*", &data, &bstarts, &bends,
                        &bgstart, &bgstop, &bqid))
    return NULL;
  PyObject* out = NULL;
  int64_t* keys = NULL;
  PyObject** vals = NULL;
  const char* base = (const char*)data.buf;
  const int64_t* starts = (const int64_t*)bstarts.buf;
  const int64_t* ends = (const int64_t*)bends.buf;
  const int64_t* gstart = (const int64_t*)bgstart.buf;
  const int64_t* gstop = (const int64_t*)bgstop.buf;
  const int64_t* qid = (const int64_t*)bqid.buf;
  Py_ssize_t T = bstarts.len / 8;
  Py_ssize_t G = bgstart.len / 8;
  size_t cap = 64;
  uint64_t mask;
  if (bends.len / 8 != T || bgstop.len / 8 != G || bqid.len / 8 != G) {
    PyErr_SetString(PyExc_ValueError, "materialize_dedup: length mismatch");
    goto done;
  }
  /* Capacity: power of two with load factor <= ~0.75 at T entries (the
   * single-group fast path below never probes, so keep its table tiny). */
  if (G > 1)
    while (cap < (size_t)T + (size_t)T / 3 + 1) cap <<= 1;
  mask = (uint64_t)cap - 1;
  keys = (int64_t*)PyMem_Malloc(cap * sizeof(int64_t));
  vals = (PyObject**)PyMem_Malloc(cap * sizeof(PyObject*));
  if (keys == NULL || vals == NULL) {
    PyErr_NoMemory();
    goto done;
  }
  memset(keys, 0xFF, cap * sizeof(int64_t)); /* -1 = empty (starts >= 0) */
  out = PyDict_New();
  if (out == NULL) goto done;
  for (Py_ssize_t g = 0; g < G; ++g) {
    int64_t a = gstart[g], b = gstop[g];
    PyObject* lst;
    if (a < 0 || b < a || b > (int64_t)T) {
      PyErr_SetString(PyExc_ValueError,
                      "materialize_dedup: group out of bounds");
      Py_CLEAR(out);
      goto done;
    }
    lst = PyList_New((Py_ssize_t)(b - a));
    if (lst == NULL) {
      Py_CLEAR(out);
      goto done;
    }
    for (int64_t t = a; t < b; ++t) {
      int64_t s = starts[t], e = ends[t];
      uint64_t z, h;
      PyObject* obj;
      if (t + 8 < b) __builtin_prefetch(base + starts[t + 8]);
      if (s < 0 || e < s || e > (int64_t)data.len) {
        PyErr_SetString(PyExc_ValueError,
                        "materialize_dedup: span out of bounds");
        Py_DECREF(lst);
        Py_CLEAR(out);
        goto done;
      }
      if (G == 1) {
        /* Single group = single query: the hash's only job is sharing one
         * str object across queries that hit the same line, so it buys
         * nothing here — skip the probe and decode directly. */
        obj = decode_line(base, s, e);
        if (obj == NULL) {
          Py_DECREF(lst);
          Py_CLEAR(out);
          goto done;
        }
        PyList_SET_ITEM(lst, (Py_ssize_t)(t - a), obj);
        continue;
      }
      z = (uint64_t)s * 0x9E3779B97F4A7C15ull;
      h = (z ^ (z >> 29)) & mask;
      while (keys[h] != -1 && keys[h] != s) h = (h + 1) & mask;
      if (keys[h] == -1) {
        obj = decode_line(base, s, e);
        if (obj == NULL) {
          Py_DECREF(lst);
          Py_CLEAR(out);
          goto done;
        }
        keys[h] = s;
        vals[h] = obj; /* table owns one ref until cleanup */
      } else {
        obj = vals[h];
      }
      Py_INCREF(obj);
      PyList_SET_ITEM(lst, (Py_ssize_t)(t - a), obj);
    }
    {
      PyObject* key = PyLong_FromLongLong(qid[g]);
      int rc = key == NULL ? -1 : PyDict_SetItem(out, key, lst);
      Py_XDECREF(key);
      Py_DECREF(lst);
      if (rc != 0) {
        Py_CLEAR(out);
        goto done;
      }
    }
  }
done:
  if (keys != NULL && vals != NULL) {
    size_t i;
    for (i = 0; i < cap; ++i)
      if (keys[i] != -1) Py_DECREF(vals[i]);
  }
  PyMem_Free(keys);
  PyMem_Free(vals);
  PyBuffer_Release(&data);
  PyBuffer_Release(&bstarts);
  PyBuffer_Release(&bends);
  PyBuffer_Release(&bgstart);
  PyBuffer_Release(&bgstop);
  PyBuffer_Release(&bqid);
  return out;
}

static PyMethodDef methods[] = {
    {"materialize", materialize, METH_VARARGS,
     "Decode distinct line spans and fan them out into per-query lists."},
    {"materialize_dedup", materialize_dedup, METH_VARARGS,
     "Decode per-occurrence spans with hash dedup of the str objects."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastext",
    "Native batch line materialization for pysubstringsearch_jax.", -1,
    methods,
};

PyMODINIT_FUNC PyInit__fastext(void) { return PyModule_Create(&moduledef); }
