/* fastingest: the host-side ingest loop of carel_tpu_torch in C.
 *
 * The reference's ingest is pure-Python list code (hot loops at
 * drl_classifier_ec_mmd_final_mul.py:631-731 and :100-117). Ingest stays on
 * the host; this moves the per-character tokenization loop of
 * ZhCharTokenizer to C for the serving path, where one host core must keep
 * the GPU fed. It is host code, not a device kernel.
 *
 * encode_chars: character-level tokenization against a codepoint->id table.
 * Fills caller-allocated int32 [N, L] id/mask buffers with exactly what the
 * Python loop (BaseTokenizer.encode, carel_tpu_torch/data/tokenizer.py)
 * gives: [CLS], then each segment's non-space characters followed by
 * [SEP], segments split at every literal "[SEP]"; a row longer than L is
 * cut to its first L - 1 ids plus [SEP]; pads after it.
 */

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>

static int is_sep_at(const void *data, int kind, Py_ssize_t pos,
                     Py_ssize_t len) {
    /* matches "[SEP]" starting at pos */
    static const Py_UCS4 SEP[5] = {'[', 'S', 'E', 'P', ']'};
    if (pos + 5 > len) return 0;
    for (int k = 0; k < 5; k++) {
        if (PyUnicode_READ(kind, data, pos + k) != SEP[k]) return 0;
    }
    return 1;
}

static PyObject *encode_chars(PyObject *self, PyObject *args) {
    PyObject *texts;
    Py_buffer table_buf, ids_buf, mask_buf;
    int max_len, cls_id, sep_id, unk_id, pad_id;

    if (!PyArg_ParseTuple(args, "Oy*w*w*iiiii", &texts, &table_buf,
                          &ids_buf, &mask_buf, &max_len, &cls_id, &sep_id,
                          &unk_id, &pad_id))
        return NULL;

    const int32_t *table = (const int32_t *)table_buf.buf;
    Py_ssize_t table_len = table_buf.len / (Py_ssize_t)sizeof(int32_t);
    int32_t *ids = (int32_t *)ids_buf.buf;
    int32_t *mask = (int32_t *)mask_buf.buf;

    Py_ssize_t n = PySequence_Size(texts);
    if (n < 0) goto fail;
    if (max_len < 2) {
        PyErr_SetString(PyExc_ValueError, "max_len must be at least 2");
        goto fail;
    }
    if (ids_buf.len < (Py_ssize_t)(n * max_len * sizeof(int32_t)) ||
        mask_buf.len < (Py_ssize_t)(n * max_len * sizeof(int32_t))) {
        PyErr_SetString(PyExc_ValueError, "output buffers too small");
        goto fail;
    }

    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *t = PySequence_GetItem(texts, i);
        if (!t) goto fail;
        if (!PyUnicode_Check(t)) {
            PyObject *s = PyObject_Str(t);
            Py_DECREF(t);
            if (!s) goto fail;
            t = s;
        }
        if (PyUnicode_READY(t) < 0) { Py_DECREF(t); goto fail; }
        int kind = PyUnicode_KIND(t);
        const void *data = PyUnicode_DATA(t);
        Py_ssize_t len = PyUnicode_GET_LENGTH(t);

        int32_t *row = ids + i * max_len;
        int32_t *mrow = mask + i * max_len;
        /* n_out counts the ids of the untruncated row; only the first
         * max_len are stored, and once it passes max_len the row is known
         * to be cut, so the rest of the text is not read */
        Py_ssize_t n_out = 0;
        row[n_out++] = cls_id;
        for (Py_ssize_t p = 0; p < len && n_out <= max_len; p++) {
            Py_UCS4 ch = PyUnicode_READ(kind, data, p);
            int32_t id;
            if (ch == '[' && is_sep_at(data, kind, p, len)) {
                id = sep_id;
                p += 4;
            } else if (Py_UNICODE_ISSPACE(ch)) {
                continue;
            } else {
                id = unk_id;
                if ((Py_ssize_t)ch < table_len && table[ch] >= 0)
                    id = table[ch];
            }
            if (n_out < max_len) row[n_out] = id;
            n_out++;
        }
        /* the last segment's [SEP] */
        if (n_out < max_len) row[n_out] = sep_id;
        n_out++;
        /* truncation keeps a final [SEP], as HF truncation does */
        if (n_out > max_len) {
            row[max_len - 1] = sep_id;
            n_out = max_len;
        }
        for (Py_ssize_t k = 0; k < n_out; k++) mrow[k] = 1;
        for (Py_ssize_t k = n_out; k < max_len; k++) {
            row[k] = pad_id;
            mrow[k] = 0;
        }
        Py_DECREF(t);
    }

    PyBuffer_Release(&table_buf);
    PyBuffer_Release(&ids_buf);
    PyBuffer_Release(&mask_buf);
    Py_RETURN_NONE;

fail:
    PyBuffer_Release(&table_buf);
    PyBuffer_Release(&ids_buf);
    PyBuffer_Release(&mask_buf);
    return NULL;
}

static PyMethodDef Methods[] = {
    {"encode_chars", encode_chars, METH_VARARGS,
     "encode_chars(texts, table_bytes, ids_buf, mask_buf, max_len, cls, sep,"
     " unk, pad)"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fastingest", NULL, -1, Methods,
};

PyMODINIT_FUNC PyInit__fastingest(void) {
    return PyModule_Create(&moduledef);
}
