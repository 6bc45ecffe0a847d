/* _ttsx_wavio — native RIFF/WAVE decoder for the host-side data loader.
 *
 * The reference stack decodes audio with torchaudio/soundfile C++ readers
 * (data_loading1/data.set.py:26-158 reads per-item wavs inside the
 * dataloader worker); on the host the Python/scipy path costs one full
 * dtype-cast + mean() pass per file in numpy temporaries. This module
 * does parse -> mono-mix -> normalize -> (optional) linear resample in a
 * single C pass straight into the output numpy buffer.
 *
 * Decode core lives in wav_core.h (shared with the _ttsx_prefetch worker
 * pool). Exposed API (see ttsx_torch/native/__init__.py for the wrapper):
 *   read_wav(path: str, target_sr: int = 0) -> (float32[T], int sr)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include "wav_core.h"

static PyObject *py_read_wav(PyObject *self, PyObject *args,
                             PyObject *kwargs) {
    static char *kwlist[] = {"path", "target_sr", NULL};
    const char *path;
    long target_sr = 0;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|l", kwlist, &path,
                                     &target_sr))
        return NULL;

    FILE *fp = fopen(path, "rb");
    if (!fp)
        return PyErr_Format(PyExc_FileNotFoundError, "cannot open %s", path);
    fseek(fp, 0, SEEK_END);
    long fsz = ftell(fp);
    fseek(fp, 0, SEEK_SET);
    if (fsz <= 0) {
        fclose(fp);
        return PyErr_Format(PyExc_ValueError, "empty file %s", path);
    }
    uint8_t *buf = (uint8_t *)malloc((size_t)fsz);
    if (!buf) {
        fclose(fp);
        return PyErr_NoMemory();
    }
    size_t got = fread(buf, 1, (size_t)fsz, fp);
    fclose(fp);

    wav_info w;
    const char *err = "parse error";
    if (wav_parse(buf, got, &w, &err) != 0) {
        free(buf);
        return PyErr_Format(PyExc_ValueError, "%s: %s", path, err);
    }
    if (wav_check(&w) != 0) {
        free(buf);
        return PyErr_Format(PyExc_ValueError,
                            "%s: unsupported encoding (fmt=%d bits=%d)", path,
                            w.format, w.bits);
    }
    size_t frame_bytes = (size_t)(w.bits / 8) * w.channels;
    size_t n_frames = w.data_len / frame_bytes;

    npy_intp out_len = (npy_intp)n_frames;
    double ratio = 1.0;
    int resample = (target_sr > 0 && (uint32_t)target_sr != w.sample_rate &&
                    n_frames > 1);
    if (resample) {
        out_len = (npy_intp)((double)n_frames * (double)target_sr /
                                 (double)w.sample_rate +
                             0.5);
        /* match numpy.interp over linspace(0, n-1, out_len) semantics
         * (ttsx_torch/data/dataset.py read_wav, scipy route) */
        ratio = (out_len > 1) ? (double)(n_frames - 1) / (double)(out_len - 1)
                              : 0.0;
    }

    PyArrayObject *arr = (PyArrayObject *)PyArray_SimpleNew(1, &out_len,
                                                            NPY_FLOAT32);
    if (!arr) {
        free(buf);
        return NULL;
    }
    float *out = (float *)PyArray_DATA(arr);

    Py_BEGIN_ALLOW_THREADS
    wav_decode_into(&w, n_frames, out, (size_t)out_len, resample, ratio);
    Py_END_ALLOW_THREADS

    long out_sr = resample ? target_sr : (long)w.sample_rate;
    free(buf);
    return Py_BuildValue("Nl", (PyObject *)arr, out_sr);
}

static PyMethodDef Methods[] = {
    {"read_wav", (PyCFunction)py_read_wav, METH_VARARGS | METH_KEYWORDS,
     "read_wav(path, target_sr=0) -> (float32 mono array, sample_rate)"},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_ttsx_wavio",
                                       NULL, -1, Methods};

PyMODINIT_FUNC PyInit__ttsx_wavio(void) {
    import_array();
    return PyModule_Create(&moduledef);
}
