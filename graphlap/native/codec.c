/* Native image utilities: netpbm codec, noise injection, PSNR.
 *
 * JAX-framework counterpart of the reference's C image I/O layer
 * (SURVEY.md §2.2 #2: "load/save grayscale & RGB images; noise injection
 * for experiments", plus the raw-format converter helpers). The device
 * compute path stays JAX/XLA/Pallas; this is the host-side runtime piece kept
 * native: binary PGM (P5) / PPM (P6) decode+encode, deterministic Gaussian
 * noise (xorshift128+ + Box-Muller), and PSNR — all operating on contiguous
 * buffers without Python-loop overhead.
 *
 * Exposed via the CPython C API as graphlap.native._native; the Python
 * wrapper (graphlap/native/__init__.py) falls back to numpy/Pillow when
 * the extension is not built.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <math.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

/* ---------------- netpbm parsing ---------------- */

static int skip_ws_comments(const unsigned char *buf, Py_ssize_t len,
                            Py_ssize_t *pos) {
    while (*pos < len) {
        unsigned char c = buf[*pos];
        if (c == '#') {
            while (*pos < len && buf[*pos] != '\n') (*pos)++;
        } else if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            (*pos)++;
        } else {
            return 0;
        }
    }
    return -1;
}

/* Dimensions/maxval above this are rejected: caps w*h*channels well under
 * Py_ssize_t and keeps the accumulation below from overflowing signed long
 * (UB) on adversarial headers. */
#define NETPBM_MAX_INT (1L << 30)

static long parse_int(const unsigned char *buf, Py_ssize_t len,
                      Py_ssize_t *pos) {
    if (skip_ws_comments(buf, len, pos) < 0) return -1;
    long v = 0;
    int any = 0;
    while (*pos < len && buf[*pos] >= '0' && buf[*pos] <= '9') {
        if (v >= NETPBM_MAX_INT) return -1;  /* before the UB, not after */
        v = v * 10 + (buf[*pos] - '0');
        (*pos)++;
        any = 1;
    }
    /* the pre-add check above only bounds v < 10*NETPBM_MAX_INT+9; enforce
     * the documented cap exactly so every caller's "< 2^30" comment holds */
    if (v >= NETPBM_MAX_INT) return -1;
    return any ? v : -1;
}

/* read_netpbm(bytes) -> (width, height, channels, bytes_f64)
 * Pixels returned as little-endian float64 in [0, 1], row-major,
 * interleaved channels. */
static PyObject *read_netpbm(PyObject *self, PyObject *args) {
    Py_buffer view;
    if (!PyArg_ParseTuple(args, "y*", &view)) return NULL;
    const unsigned char *buf = (const unsigned char *)view.buf;
    Py_ssize_t len = view.len, pos = 0;

    if (len < 2 || buf[0] != 'P' || (buf[1] != '5' && buf[1] != '6')) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "not a binary PGM (P5) / PPM (P6)");
        return NULL;
    }
    int channels = (buf[1] == '5') ? 1 : 3;
    pos = 2;
    long w = parse_int(buf, len, &pos);
    long h = parse_int(buf, len, &pos);
    long maxval = parse_int(buf, len, &pos);
    if (w <= 0 || h <= 0 || maxval <= 0 || maxval > 65535) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "bad netpbm header");
        return NULL;
    }
    pos++; /* single whitespace after maxval */
    int two_byte = maxval > 255;
    /* division-based overflow check before allocating (w, h < 2^30 each,
     * but their product can still exceed Py_ssize_t on 32-bit builds and
     * is absurd for an image either way) */
    if ((Py_ssize_t)w > (PY_SSIZE_T_MAX / 16) / h / channels) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "netpbm dimensions too large");
        return NULL;
    }
    Py_ssize_t npix = (Py_ssize_t)w * h * channels;
    Py_ssize_t need = npix * (two_byte ? 2 : 1);
    if (len - pos < need) {
        PyBuffer_Release(&view);
        PyErr_SetString(PyExc_ValueError, "truncated netpbm payload");
        return NULL;
    }

    PyObject *out = PyBytes_FromStringAndSize(NULL, npix * (Py_ssize_t)sizeof(double));
    if (!out) { PyBuffer_Release(&view); return NULL; }
    double *dst = (double *)PyBytes_AS_STRING(out);
    const unsigned char *src = buf + pos;
    double mv = (double)maxval;   /* divide (not multiply by reciprocal):
                                      bit-identical to the numpy fallback */
    if (two_byte) {
        for (Py_ssize_t i = 0; i < npix; i++)
            dst[i] = ((src[2 * i] << 8) | src[2 * i + 1]) / mv; /* big-endian */
    } else {
        for (Py_ssize_t i = 0; i < npix; i++)
            dst[i] = src[i] / mv;
    }
    PyBuffer_Release(&view);
    return Py_BuildValue("lliN", w, h, channels, out);
}

/* write_netpbm(width, height, channels, bytes_f64) -> bytes */
static PyObject *write_netpbm(PyObject *self, PyObject *args) {
    long w, h;
    int channels;
    Py_buffer data;
    if (!PyArg_ParseTuple(args, "lliy*", &w, &h, &channels, &data))
        return NULL;
    if (w <= 0 || h <= 0 || w >= NETPBM_MAX_INT || h >= NETPBM_MAX_INT ||
        (channels != 1 && channels != 3) ||
        (Py_ssize_t)w > (PY_SSIZE_T_MAX / 16) / h / channels) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "bad dimensions or channels");
        return NULL;
    }
    Py_ssize_t npix = (Py_ssize_t)w * h * channels;
    if (data.len != npix * (Py_ssize_t)sizeof(double) ||
        (channels != 1 && channels != 3)) {
        PyBuffer_Release(&data);
        PyErr_SetString(PyExc_ValueError, "bad buffer size or channels");
        return NULL;
    }
    char header[64];
    int hlen = snprintf(header, sizeof(header), "P%c\n%ld %ld\n255\n",
                        channels == 1 ? '5' : '6', w, h);
    PyObject *out = PyBytes_FromStringAndSize(NULL, hlen + npix);
    if (!out) { PyBuffer_Release(&data); return NULL; }
    unsigned char *dst = (unsigned char *)PyBytes_AS_STRING(out);
    memcpy(dst, header, (size_t)hlen);
    dst += hlen;
    const double *src = (const double *)data.buf;
    for (Py_ssize_t i = 0; i < npix; i++) {
        double v = src[i];
        if (v < 0.0) v = 0.0;
        if (v > 1.0) v = 1.0;
        dst[i] = (unsigned char)(v * 255.0 + 0.5);
    }
    PyBuffer_Release(&data);
    return out;
}

/* ---------------- noise + metrics ---------------- */

static inline uint64_t xorshift128p(uint64_t s[2]) {
    uint64_t x = s[0];
    const uint64_t y = s[1];
    s[0] = y;
    x ^= x << 23;
    s[1] = x ^ y ^ (x >> 17) ^ (y >> 26);
    return s[1] + y;
}

static inline double u01(uint64_t s[2]) {
    return (double)(xorshift128p(s) >> 11) * (1.0 / 9007199254740992.0);
}

/* add_noise(bytes_f64, sigma, seed) -> bytes_f64 (x + N(0, sigma^2)) */
static PyObject *add_noise(PyObject *self, PyObject *args) {
    Py_buffer data;
    double sigma;
    unsigned long long seed;
    if (!PyArg_ParseTuple(args, "y*dK", &data, &sigma, &seed)) return NULL;
    Py_ssize_t n = data.len / (Py_ssize_t)sizeof(double);
    PyObject *out = PyBytes_FromStringAndSize(NULL, data.len);
    if (!out) { PyBuffer_Release(&data); return NULL; }
    const double *src = (const double *)data.buf;
    double *dst = (double *)PyBytes_AS_STRING(out);
    uint64_t s[2] = {seed ^ 0x9E3779B97F4A7C15ULL,
                     (seed << 1) | 0x243F6A8885A308D3ULL};
    for (int k = 0; k < 8; k++) (void)xorshift128p(s); /* warm up */
    Py_ssize_t i = 0;
    while (i < n) {
        /* Box-Muller pair */
        double u1 = u01(s), u2 = u01(s);
        if (u1 < 1e-300) u1 = 1e-300;
        double r = sqrt(-2.0 * log(u1)) * sigma;
        dst[i] = src[i] + r * cos(2.0 * M_PI * u2);
        i++;
        if (i < n) { dst[i] = src[i] + r * sin(2.0 * M_PI * u2); i++; }
    }
    PyBuffer_Release(&data);
    return out;
}

/* psnr(bytes_f64_ref, bytes_f64_test, data_range) -> float (dB; inf if equal) */
static PyObject *psnr_c(PyObject *self, PyObject *args) {
    Py_buffer a, b;
    double range;
    if (!PyArg_ParseTuple(args, "y*y*d", &a, &b, &range)) return NULL;
    if (a.len != b.len || a.len == 0) {
        PyBuffer_Release(&a); PyBuffer_Release(&b);
        PyErr_SetString(PyExc_ValueError, "size mismatch");
        return NULL;
    }
    Py_ssize_t n = a.len / (Py_ssize_t)sizeof(double);
    const double *x = (const double *)a.buf, *y = (const double *)b.buf;
    double acc = 0.0;
    for (Py_ssize_t i = 0; i < n; i++) {
        double d = x[i] - y[i];
        acc += d * d;
    }
    PyBuffer_Release(&a); PyBuffer_Release(&b);
    double mse = acc / (double)n;
    if (mse == 0.0) return PyFloat_FromDouble(INFINITY);
    return PyFloat_FromDouble(10.0 * log10(range * range / mse));
}


/* --- SSIM (Wang et al. 2004): Gaussian 11x11 window, reflect padding ----- */

static inline Py_ssize_t refl(Py_ssize_t i, Py_ssize_t n) {
    /* numpy pad mode="reflect": -1 -> 1, n -> n-2 (edge not repeated) */
    if (i < 0) i = -i;
    if (i >= n) i = 2 * n - 2 - i;
    return i;
}

/* separable Gaussian blur, kernel length 2*radius+1, into dst (tmp scratch) */
static void blur2d(const double *src, double *dst, double *tmp,
                   Py_ssize_t h, Py_ssize_t w, const double *k, int radius) {
    for (Py_ssize_t y = 0; y < h; y++)
        for (Py_ssize_t x = 0; x < w; x++) {
            double acc = 0.0;
            for (int t = -radius; t <= radius; t++)
                acc += src[y * w + refl(x + t, w)] * k[t + radius];
            tmp[y * w + x] = acc;
        }
    for (Py_ssize_t y = 0; y < h; y++)
        for (Py_ssize_t x = 0; x < w; x++) {
            double acc = 0.0;
            for (int t = -radius; t <= radius; t++)
                acc += tmp[refl(y + t, h) * w + x] * k[t + radius];
            dst[y * w + x] = acc;
        }
}

/* ssim(ref_bytes, test_bytes, h, w, data_range, sigma) -> float.
   One grayscale channel; the Python wrapper averages channels. Twin of
   graphlap.metrics.ssim (radius 5, same constants). */
static PyObject *ssim_c(PyObject *self, PyObject *args) {
    Py_buffer a, b;
    Py_ssize_t h, w;
    double range, sigma;
    if (!PyArg_ParseTuple(args, "y*y*nndd", &a, &b, &h, &w, &range, &sigma))
        return NULL;
    const int radius = 5;
    if (a.len != b.len || a.len != h * w * (Py_ssize_t)sizeof(double)
        || h <= radius || w <= radius) {
        PyBuffer_Release(&a); PyBuffer_Release(&b);
        PyErr_SetString(PyExc_ValueError,
                        "ssim: size mismatch or image smaller than window");
        return NULL;
    }
    double k[2 * 5 + 1], ksum = 0.0;
    for (int t = -radius; t <= radius; t++) {
        k[t + radius] = exp(-0.5 * (double)(t * t) / (sigma * sigma));
        ksum += k[t + radius];
    }
    for (int t = 0; t < 2 * radius + 1; t++) k[t] /= ksum;

    Py_ssize_t n = h * w;
    /* mu_x, mu_y, xx, yy, xy + products + scratch: 9 planes */
    double *mem = (double *)PyMem_Malloc((size_t)n * 9 * sizeof(double));
    if (!mem) { PyBuffer_Release(&a); PyBuffer_Release(&b); return PyErr_NoMemory(); }
    const double *x = (const double *)a.buf, *y = (const double *)b.buf;
    double *mux = mem, *muy = mem + n, *mxx = mem + 2 * n, *myy = mem + 3 * n,
           *mxy = mem + 4 * n, *px = mem + 5 * n, *py = mem + 6 * n,
           *pxy = mem + 7 * n, *tmp = mem + 8 * n;
    for (Py_ssize_t i = 0; i < n; i++) {
        px[i] = x[i] * x[i];
        py[i] = y[i] * y[i];
        pxy[i] = x[i] * y[i];
    }
    blur2d(x, mux, tmp, h, w, k, radius);
    blur2d(y, muy, tmp, h, w, k, radius);
    blur2d(px, mxx, tmp, h, w, k, radius);
    blur2d(py, myy, tmp, h, w, k, radius);
    blur2d(pxy, mxy, tmp, h, w, k, radius);

    const double c1 = (0.01 * range) * (0.01 * range);
    const double c2 = (0.03 * range) * (0.03 * range);
    double acc = 0.0;
    for (Py_ssize_t i = 0; i < n; i++) {
        double vx = mxx[i] - mux[i] * mux[i];
        double vy = myy[i] - muy[i] * muy[i];
        double cov = mxy[i] - mux[i] * muy[i];
        double num = (2.0 * mux[i] * muy[i] + c1) * (2.0 * cov + c2);
        double den = (mux[i] * mux[i] + muy[i] * muy[i] + c1)
                     * (vx + vy + c2);
        acc += num / den;
    }
    PyMem_Free(mem);
    PyBuffer_Release(&a); PyBuffer_Release(&b);
    return PyFloat_FromDouble(acc / (double)n);
}

static PyMethodDef methods[] = {
    {"read_netpbm", read_netpbm, METH_VARARGS,
     "read_netpbm(data) -> (w, h, channels, float64_bytes)"},
    {"write_netpbm", write_netpbm, METH_VARARGS,
     "write_netpbm(w, h, channels, float64_bytes) -> bytes"},
    {"add_noise", add_noise, METH_VARARGS,
     "add_noise(float64_bytes, sigma, seed) -> float64_bytes"},
    {"psnr", psnr_c, METH_VARARGS,
     "psnr(ref_bytes, test_bytes, data_range) -> dB"},
    {"ssim", ssim_c, METH_VARARGS,
     "ssim(ref_bytes, test_bytes, h, w, data_range, sigma) -> mean SSIM"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_native",
    "Native netpbm codec + noise + PSNR/SSIM for graphlap", -1, methods,
};

PyMODINIT_FUNC PyInit__native(void) { return PyModule_Create(&moduledef); }
