/*
 * _ply.cpp — native PLY point-cloud serialization.
 *
 * The framework's runtime counterpart to the reference's C++
 * layer (/root/reference/simplestereo/_passive.cpp builds its native code
 * with setuptools the same way, setup.py:35-48): dense compute lives in
 * Pallas/XLA, but host-side I/O of multi-million-point clouds is a
 * serialization hot path that Python formatting dominates. This module
 * writes/parses the reference-compatible ASCII PLY format
 * (points.py:10-120) in C++ with snprintf/strtod loops and releases the
 * GIL around file work.
 *
 * Exposed functions (raw CPython API, no pybind dependency):
 *   write_xyz(path, header_bytes, xyz_f64, precision)          -> None
 *   write_xyz_rgb(path, header_bytes, xyz_f64, rgb_u8, precision) -> None
 *   write_xyz_intensity(path, header, xyz_f64, vals_f64, as_int,
 *                       precision) -> None
 *   read_ascii_floats(path, n_skip_lines, n_rows, n_cols) -> bytes(f64)
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct FileCloser {
    FILE *f;
    ~FileCloser() { if (f) fclose(f); }
};

// Parse a contiguous float64 buffer out of a bytes-like object.
static int as_f64(PyObject *obj, Py_buffer *view) {
    if (PyObject_GetBuffer(obj, view, PyBUF_CONTIG_RO) != 0) return -1;
    return 0;
}

static PyObject *write_common(PyObject *args, int mode) {
    const char *path;
    Py_buffer header, xyz, extra;
    extra.buf = nullptr;
    int precision = 6;
    int as_int = 0;

    if (mode == 0) {  // xyz only
        if (!PyArg_ParseTuple(args, "sy*y*i", &path, &header, &xyz,
                              &precision))
            return nullptr;
    } else if (mode == 1) {  // xyz + rgb
        if (!PyArg_ParseTuple(args, "sy*y*y*i", &path, &header, &xyz,
                              &extra, &precision))
            return nullptr;
    } else {  // xyz + intensity
        if (!PyArg_ParseTuple(args, "sy*y*y*ii", &path, &header, &xyz,
                              &extra, &as_int, &precision))
            return nullptr;
    }

    const double *p = static_cast<const double *>(xyz.buf);
    Py_ssize_t n = xyz.len / (3 * (Py_ssize_t)sizeof(double));
    const unsigned char *rgb = nullptr;
    const double *vals = nullptr;
    if (mode == 1) rgb = static_cast<const unsigned char *>(extra.buf);
    if (mode == 2) vals = static_cast<const double *>(extra.buf);

    int ok = 1;
    Py_BEGIN_ALLOW_THREADS
    FILE *f = fopen(path, "wb");
    if (!f) {
        ok = 0;
    } else {
        FileCloser closer{f};
        fwrite(header.buf, 1, header.len, f);
        char fmt[64];
        char line[256];
        snprintf(fmt, sizeof(fmt), "%%.%df %%.%df %%.%df", precision,
                 precision, precision);
        for (Py_ssize_t i = 0; i < n; ++i) {
            int len = snprintf(line, sizeof(line), fmt, p[3 * i],
                               p[3 * i + 1], p[3 * i + 2]);
            if (mode == 1) {
                len += snprintf(line + len, sizeof(line) - len,
                                " %u %u %u", rgb[3 * i], rgb[3 * i + 1],
                                rgb[3 * i + 2]);
            } else if (mode == 2) {
                if (as_int)
                    len += snprintf(line + len, sizeof(line) - len,
                                    " %lld", (long long)vals[i]);
                else
                    len += snprintf(line + len, sizeof(line) - len,
                                    " %.*f", precision, vals[i]);
            }
            line[len++] = '\n';
            if (fwrite(line, 1, len, f) != (size_t)len) { ok = 0; break; }
        }
    }
    Py_END_ALLOW_THREADS

    PyBuffer_Release(&header);
    PyBuffer_Release(&xyz);
    if (extra.buf) PyBuffer_Release(&extra);
    if (!ok) {
        PyErr_SetString(PyExc_OSError, "PLY write failed");
        return nullptr;
    }
    Py_RETURN_NONE;
}

static PyObject *write_xyz(PyObject *, PyObject *args) {
    return write_common(args, 0);
}
static PyObject *write_xyz_rgb(PyObject *, PyObject *args) {
    return write_common(args, 1);
}
static PyObject *write_xyz_intensity(PyObject *, PyObject *args) {
    return write_common(args, 2);
}

// Read n_rows lines of whitespace-separated floats after skipping the
// header; returns the raw little-endian f64 buffer (n_rows * n_cols).
static PyObject *read_ascii_floats(PyObject *, PyObject *args) {
    const char *path;
    Py_ssize_t n_skip, n_rows, n_cols;
    if (!PyArg_ParseTuple(args, "snnn", &path, &n_skip, &n_rows, &n_cols))
        return nullptr;

    std::vector<double> out;
    int ok = 1;
    Py_BEGIN_ALLOW_THREADS
    FILE *f = fopen(path, "rb");
    if (!f) {
        ok = 0;
    } else {
        FileCloser closer{f};
        out.reserve((size_t)(n_rows * n_cols));
        char *line = nullptr;
        size_t cap = 0;
        for (Py_ssize_t i = 0; i < n_skip; ++i)
            if (getline(&line, &cap, f) < 0) { ok = 0; break; }
        for (Py_ssize_t r = 0; ok && r < n_rows; ++r) {
            if (getline(&line, &cap, f) < 0) { ok = 0; break; }
            char *s = line;
            for (Py_ssize_t c = 0; c < n_cols; ++c) {
                char *end;
                double v = strtod(s, &end);
                if (end == s) { ok = 0; break; }
                out.push_back(v);
                s = end;
            }
        }
        free(line);
    }
    Py_END_ALLOW_THREADS

    if (!ok) {
        PyErr_SetString(PyExc_OSError, "PLY read failed");
        return nullptr;
    }
    return PyBytes_FromStringAndSize(
        reinterpret_cast<const char *>(out.data()),
        (Py_ssize_t)(out.size() * sizeof(double)));
}

static PyMethodDef Methods[] = {
    {"write_xyz", write_xyz, METH_VARARGS, "write xyz PLY body"},
    {"write_xyz_rgb", write_xyz_rgb, METH_VARARGS, "write xyz+rgb body"},
    {"write_xyz_intensity", write_xyz_intensity, METH_VARARGS,
     "write xyz+intensity body"},
    {"read_ascii_floats", read_ascii_floats, METH_VARARGS,
     "read whitespace-separated floats"},
    {nullptr, nullptr, 0, nullptr}};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_ply", "native PLY serialization", -1, Methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__ply(void) { return PyModule_Create(&moduledef); }
