/* _ttsx_prefetch — native host data-loading executor.
 *
 * The reference trains through torch DataLoader(num_workers=4) worker
 * processes (reference_encoder/train.py:52-69, batching2/colate.py); this
 * is the ttsx equivalent: a pthreads worker pool that decodes wav files
 * (same single-pass RIFF decoder as _ttsx_wavio), random-crops to a fixed
 * length, and assembles whole [batch, crop] float32 batches into a
 * bounded ring buffer so the accelerator step never waits on host IO.
 *
 * Workers run entirely outside the GIL (paths are copied to C strings at
 * construction; slots are plain malloc buffers). The consumer thread pays
 * one memcpy into a fresh numpy array per batch.
 *
 * API:
 *   Prefetcher(paths, labels, crop, batch, target_sr=0, workers=2,
 *              depth=4, seed=0)
 *   .next(timeout_ms=10000) -> (float32[batch, crop], int32[batch])
 *   .close()
 *   .stats() -> (produced, consumed, decode_errors)
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "wav_core.h"

typedef struct {
    float *wav;      /* [batch * crop] */
    int32_t *label;  /* [batch] */
    int ready;
} slot_t;

typedef struct {
    PyObject_HEAD
    char **paths;
    int32_t *labels;
    size_t n_files;
    long target_sr;
    size_t crop;
    size_t batch;
    int depth;
    int n_workers;
    pthread_t *threads;
    slot_t *slots;
    /* ring of ready slot indices */
    int *ready_ring;
    int ready_head, ready_tail, ready_count;
    /* ring of free slot indices */
    int *free_ring;
    int free_head, free_tail, free_count;
    pthread_mutex_t mu;
    pthread_cond_t cv_ready, cv_free;
    int stop;
    int started;
    int next_wid;
    uint64_t produced, consumed, decode_errors;
    uint64_t seed;
} Prefetcher;

static uint64_t xorshift64(uint64_t *s) {
    uint64_t x = *s;
    x ^= x << 13;
    x ^= x >> 7;
    x ^= x << 17;
    *s = x ? x : 0x9E3779B97F4A7C15ULL;
    return *s;
}

/* Decode one file into out[crop] (random-crop / zero-pad). Returns 0 ok. */
static int load_item(Prefetcher *pf, const char *path, uint64_t *rng,
                     float *out) {
    size_t n = 0;
    float *wav = wav_core_read(path, pf->target_sr, &n, NULL);
    if (!wav)
        return -1;
    if (n >= pf->crop) {
        /* valid starts are [0, n-crop] inclusive — n-crop+1 choices,
         * matching the Python fallback's rng.integers(0, n-crop+1) */
        size_t start = xorshift64(rng) % (n - pf->crop + 1);
        memcpy(out, wav + start, pf->crop * sizeof(float));
    } else {
        memcpy(out, wav, n * sizeof(float));
        memset(out + n, 0, (pf->crop - n) * sizeof(float));
    }
    free(wav);
    return 0;
}

static void *worker_main(void *arg) {
    Prefetcher *pf = (Prefetcher *)arg;
    /* deterministic per-worker stream: seed + worker index (an atomic
     * ticket), like the Python fallback's default_rng(seed + wid) —
     * pthread_self() here would silently break seed reproducibility */
    int wid = __sync_fetch_and_add(&pf->next_wid, 1);
    uint64_t rng = pf->seed + 0x9E3779B97F4A7C15ULL * (uint64_t)(wid + 1);
    xorshift64(&rng);
    for (;;) {
        /* acquire a free slot */
        pthread_mutex_lock(&pf->mu);
        while (!pf->stop && pf->free_count == 0)
            pthread_cond_wait(&pf->cv_free, &pf->mu);
        if (pf->stop) {
            pthread_mutex_unlock(&pf->mu);
            return NULL;
        }
        int si = pf->free_ring[pf->free_head];
        pf->free_head = (pf->free_head + 1) % (pf->depth + 1);
        pf->free_count--;
        pthread_mutex_unlock(&pf->mu);

        slot_t *slot = &pf->slots[si];
        for (size_t b = 0; b < pf->batch; b++) {
            size_t idx = xorshift64(&rng) % pf->n_files;
            /* retry other files on decode failure so a bad file cannot
             * poison a batch (matches the defensive per-item try/except
             * of the reference collator) */
            int tries = 0;
            int32_t label = pf->labels[idx];
            while (load_item(pf, pf->paths[idx], &rng,
                             slot->wav + b * pf->crop) != 0) {
                __sync_fetch_and_add(&pf->decode_errors, 1);
                idx = xorshift64(&rng) % pf->n_files;
                label = pf->labels[idx];
                if (++tries > 16) {
                    /* exhausted: zero wav + sentinel label -1, never a
                     * real speaker id (silence labeled as a genuine
                     * utterance would pollute that speaker's embedding;
                     * consumers filter rows with label < 0) */
                    memset(slot->wav + b * pf->crop, 0,
                           pf->crop * sizeof(float));
                    label = -1;
                    break;
                }
            }
            slot->label[b] = label;
        }

        pthread_mutex_lock(&pf->mu);
        pf->ready_ring[pf->ready_tail] = si;
        pf->ready_tail = (pf->ready_tail + 1) % (pf->depth + 1);
        pf->ready_count++;
        pf->produced++;
        pthread_cond_signal(&pf->cv_ready);
        pthread_mutex_unlock(&pf->mu);
    }
}

static int Prefetcher_init(Prefetcher *self, PyObject *args,
                           PyObject *kwargs) {
    static char *kwlist[] = {"paths",   "labels", "crop", "batch",
                             "target_sr", "workers", "depth", "seed", NULL};
    PyObject *paths_obj, *labels_obj;
    Py_ssize_t crop, batch;
    long target_sr = 0, workers = 2, depth = 4, seed = 0;
    if (!PyArg_ParseTupleAndKeywords(
            args, kwargs, "OOnn|llll", kwlist, &paths_obj, &labels_obj,
            &crop, &batch, &target_sr, &workers, &depth, &seed))
        return -1;
    PyObject *paths = PySequence_Fast(paths_obj, "paths must be a sequence");
    if (!paths)
        return -1;
    PyObject *labels = PySequence_Fast(labels_obj,
                                       "labels must be a sequence");
    if (!labels) {
        Py_DECREF(paths);
        return -1;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(paths);
    if (n == 0 || PySequence_Fast_GET_SIZE(labels) != n || crop <= 0 ||
        batch <= 0 || workers < 1 || depth < 1) {
        PyErr_SetString(PyExc_ValueError,
                        "need non-empty paths, len(labels)==len(paths), "
                        "crop/batch/workers/depth >= 1");
        Py_DECREF(paths);
        Py_DECREF(labels);
        return -1;
    }
    self->n_files = (size_t)n;
    self->paths = (char **)calloc(n, sizeof(char *));
    self->labels = (int32_t *)calloc(n, sizeof(int32_t));
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *it = PySequence_Fast_GET_ITEM(paths, i);
        const char *s = PyUnicode_AsUTF8(it);
        long lab = PyLong_AsLong(PySequence_Fast_GET_ITEM(labels, i));
        if (!s || (lab == -1 && PyErr_Occurred())) {
            Py_DECREF(paths);
            Py_DECREF(labels);
            return -1;
        }
        self->paths[i] = strdup(s);
        self->labels[i] = (int32_t)lab;
    }
    Py_DECREF(paths);
    Py_DECREF(labels);

    self->crop = (size_t)crop;
    self->batch = (size_t)batch;
    self->target_sr = target_sr;
    self->depth = (int)depth;
    self->n_workers = (int)workers;
    self->seed = (uint64_t)seed + 1;
    self->stop = 0;
    self->next_wid = 0;
    self->produced = self->consumed = self->decode_errors = 0;
    pthread_mutex_init(&self->mu, NULL);
    pthread_cond_init(&self->cv_ready, NULL);
    pthread_cond_init(&self->cv_free, NULL);
    self->slots = (slot_t *)calloc(depth, sizeof(slot_t));
    self->ready_ring = (int *)calloc(depth + 1, sizeof(int));
    self->free_ring = (int *)calloc(depth + 1, sizeof(int));
    self->ready_head = self->ready_tail = self->ready_count = 0;
    self->free_head = self->free_tail = self->free_count = 0;
    for (int i = 0; i < depth; i++) {
        self->slots[i].wav =
            (float *)malloc(self->batch * self->crop * sizeof(float));
        self->slots[i].label =
            (int32_t *)malloc(self->batch * sizeof(int32_t));
        self->free_ring[self->free_tail] = i;
        self->free_tail = (self->free_tail + 1) % (depth + 1);
        self->free_count++;
    }
    self->threads = (pthread_t *)calloc(workers, sizeof(pthread_t));
    for (int i = 0; i < workers; i++)
        pthread_create(&self->threads[i], NULL, worker_main, self);
    self->started = 1;
    return 0;
}

static void prefetcher_shutdown(Prefetcher *self) {
    if (!self->started)
        return;
    pthread_mutex_lock(&self->mu);
    self->stop = 1;
    pthread_cond_broadcast(&self->cv_free);
    pthread_cond_broadcast(&self->cv_ready);
    pthread_mutex_unlock(&self->mu);
    for (int i = 0; i < self->n_workers; i++)
        pthread_join(self->threads[i], NULL);
    self->started = 0;
}

static PyObject *Prefetcher_next(Prefetcher *self, PyObject *args,
                                 PyObject *kwargs) {
    static char *kwlist[] = {"timeout_ms", NULL};
    long timeout_ms = 10000;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|l", kwlist,
                                     &timeout_ms))
        return NULL;
    if (!self->started) {
        PyErr_SetString(PyExc_RuntimeError, "prefetcher is closed");
        return NULL;
    }
    struct timespec ts;
    clock_gettime(CLOCK_REALTIME, &ts);
    ts.tv_sec += timeout_ms / 1000;
    ts.tv_nsec += (timeout_ms % 1000) * 1000000L;
    if (ts.tv_nsec >= 1000000000L) {
        ts.tv_sec += 1;
        ts.tv_nsec -= 1000000000L;
    }

    int si = -1, timed_out = 0;
    Py_BEGIN_ALLOW_THREADS
    pthread_mutex_lock(&self->mu);
    while (!self->stop && self->ready_count == 0) {
        if (pthread_cond_timedwait(&self->cv_ready, &self->mu, &ts) != 0) {
            timed_out = 1;
            break;
        }
    }
    /* re-check under the lock: a producer may signal concurrently with
     * timeout expiry (POSIX allows ETIMEDOUT with the predicate true) —
     * a ready batch always wins over a spurious TimeoutError */
    (void)timed_out;
    if (self->ready_count > 0) {
        si = self->ready_ring[self->ready_head];
        self->ready_head = (self->ready_head + 1) % (self->depth + 1);
        self->ready_count--;
    }
    pthread_mutex_unlock(&self->mu);
    Py_END_ALLOW_THREADS
    if (si < 0)
        return PyErr_Format(PyExc_TimeoutError,
                            "no batch within %ld ms", timeout_ms);

    npy_intp wdims[2] = {(npy_intp)self->batch, (npy_intp)self->crop};
    npy_intp ldims[1] = {(npy_intp)self->batch};
    PyArrayObject *wav =
        (PyArrayObject *)PyArray_SimpleNew(2, wdims, NPY_FLOAT32);
    PyArrayObject *lab =
        (PyArrayObject *)PyArray_SimpleNew(1, ldims, NPY_INT32);
    if (!wav || !lab) {
        Py_XDECREF(wav);
        Py_XDECREF(lab);
        return NULL;
    }
    memcpy(PyArray_DATA(wav), self->slots[si].wav,
           self->batch * self->crop * sizeof(float));
    memcpy(PyArray_DATA(lab), self->slots[si].label,
           self->batch * sizeof(int32_t));

    pthread_mutex_lock(&self->mu);
    self->free_ring[self->free_tail] = si;
    self->free_tail = (self->free_tail + 1) % (self->depth + 1);
    self->free_count++;
    self->consumed++;
    pthread_cond_signal(&self->cv_free);
    pthread_mutex_unlock(&self->mu);
    return Py_BuildValue("NN", (PyObject *)wav, (PyObject *)lab);
}

static PyObject *Prefetcher_close(Prefetcher *self, PyObject *ignored) {
    prefetcher_shutdown(self);
    Py_RETURN_NONE;
}

static PyObject *Prefetcher_stats(Prefetcher *self, PyObject *ignored) {
    return Py_BuildValue("KKK", (unsigned long long)self->produced,
                         (unsigned long long)self->consumed,
                         (unsigned long long)self->decode_errors);
}

static void Prefetcher_dealloc(Prefetcher *self) {
    prefetcher_shutdown(self);
    for (size_t i = 0; i < self->n_files; i++)
        free(self->paths[i]);
    free(self->paths);
    free(self->labels);
    if (self->slots) {
        for (int i = 0; i < self->depth; i++) {
            free(self->slots[i].wav);
            free(self->slots[i].label);
        }
    }
    free(self->slots);
    free(self->ready_ring);
    free(self->free_ring);
    free(self->threads);
    pthread_mutex_destroy(&self->mu);
    pthread_cond_destroy(&self->cv_ready);
    pthread_cond_destroy(&self->cv_free);
    Py_TYPE(self)->tp_free((PyObject *)self);
}

static PyMethodDef Prefetcher_methods[] = {
    {"next", (PyCFunction)Prefetcher_next, METH_VARARGS | METH_KEYWORDS,
     "next(timeout_ms=10000) -> (wav [batch, crop] f32, labels [batch] i32)"},
    {"close", (PyCFunction)Prefetcher_close, METH_NOARGS, "stop workers"},
    {"stats", (PyCFunction)Prefetcher_stats, METH_NOARGS,
     "(produced, consumed, decode_errors)"},
    {NULL, NULL, 0, NULL}};

static PyTypeObject PrefetcherType = {
    PyVarObject_HEAD_INIT(NULL, 0).tp_name = "_ttsx_prefetch.Prefetcher",
    .tp_basicsize = sizeof(Prefetcher),
    .tp_flags = Py_TPFLAGS_DEFAULT,
    .tp_new = PyType_GenericNew,
    .tp_init = (initproc)Prefetcher_init,
    .tp_dealloc = (destructor)Prefetcher_dealloc,
    .tp_methods = Prefetcher_methods,
};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT,
                                       "_ttsx_prefetch", NULL, -1, NULL};

PyMODINIT_FUNC PyInit__ttsx_prefetch(void) {
    import_array();
    if (PyType_Ready(&PrefetcherType) < 0)
        return NULL;
    PyObject *m = PyModule_Create(&moduledef);
    if (!m)
        return NULL;
    Py_INCREF(&PrefetcherType);
    PyModule_AddObject(m, "Prefetcher", (PyObject *)&PrefetcherType);
    return m;
}
