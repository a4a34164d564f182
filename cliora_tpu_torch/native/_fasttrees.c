/* Native host-side CKY backpointer decode (CPython C API).
 *
 * The port's own copy of cliora_tpu/native/_fasttrees.c.  The device-side
 * CKY (ops/inside_cky.py, ops/chart_pass.py) emits one (B, ncells) int32
 * backpointer array per batch; turning rows into nested-tuple trees and
 * span lists is the host half of the parse path.  The pure-python
 * decoder (analysis/trees.py bp_to_tree / tree_to_spans) walks one
 * sentence at a time, so the batch decode loop lives here in C.
 * analysis/trees.py remains the behavior oracle;
 * tests/test_torch_trees.py pins exact parity (trees, spans, and span
 * order).
 *
 * (reference decode: cliora/analysis/cky.py:31-109 -- per-cell host
 * python loops; this repo keeps the argmax on device and only walks
 * backpointers on the host.)
 *
 * Chart layout (chart/offsets.py): flat level-major; level L holds the
 * n-L spans of length L+1; offset(L) = ncells - (n-L)(n-L+1)/2; cell
 * (level, pos) covers tokens [pos, pos+level].  bp[cell(level, pos)] =
 * split k: children (k, pos) and (level-k-1, pos+k+1).
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

typedef struct {
    const int32_t *bp;   /* one row: ncells int32 backpointers */
    const int64_t *offs; /* level -> flat offset, length n */
    PyObject *spans;     /* list; (pos, pos+level) appended post-order */
} DecodeCtx;

/* Recursively build the nested-tuple tree rooted at cell (level, pos),
 * appending each internal node's inclusive span post-order (so the root
 * span is last, matching tree_to_spans' contract that callers rely on
 * for the reference's root-drop slicing).  Recursion depth <= level+1,
 * bounded by the sentence length. */
static PyObject *
build_node(DecodeCtx *c, long level, long pos)
{
    long k;
    PyObject *l, *r, *t, *span;

    if (level == 0)
        return PyLong_FromLong(pos);
    k = (long)c->bp[c->offs[level] + pos];
    if (k < 0 || k >= level) {
        PyErr_Format(PyExc_ValueError,
                     "invalid backpointer %ld at cell (level=%ld, pos=%ld)",
                     k, level, pos);
        return NULL;
    }
    l = build_node(c, k, pos);
    if (l == NULL)
        return NULL;
    r = build_node(c, level - k - 1, pos + k + 1);
    if (r == NULL) {
        Py_DECREF(l);
        return NULL;
    }
    t = PyTuple_Pack(2, l, r);
    Py_DECREF(l);
    Py_DECREF(r);
    if (t == NULL)
        return NULL;
    span = Py_BuildValue("(ll)", pos, pos + level);
    if (span == NULL || PyList_Append(c->spans, span) < 0) {
        Py_XDECREF(span);
        Py_DECREF(t);
        return NULL;
    }
    Py_DECREF(span);
    return t;
}

/* decode_batch(bp, n, lengths=None) -> (trees, spans)
 *
 * bp: C-contiguous int32 buffer of B*ncells(n) backpointers.
 * n: padded chart length (layout size).
 * lengths: optional C-contiguous int32 buffer of B true lengths m <= n
 *   (padded length-bucket charts root the decode at cell (m-1, 0)).
 * Returns ([tree]*B, [[(l, r), ...]]*B): nested int/tuple trees and
 * post-order inclusive span lists, exactly as bp_to_tree/tree_to_spans.
 */
static PyObject *
decode_batch(PyObject *self, PyObject *args)
{
    Py_buffer bpbuf = {0};
    Py_buffer lenbuf = {0};
    PyObject *lengths_obj = Py_None;
    long n;
    int64_t *offs = NULL;
    PyObject *trees = NULL, *spans = NULL, *out = NULL;
    Py_ssize_t ncells, B, b;
    long level;

    if (!PyArg_ParseTuple(args, "y*l|O:decode_batch",
                          &bpbuf, &n, &lengths_obj))
        return NULL;
    if (n < 1) {
        PyErr_SetString(PyExc_ValueError, "n must be >= 1");
        goto fail;
    }
    ncells = (Py_ssize_t)n * (n + 1) / 2;
    if (bpbuf.len % (ncells * (Py_ssize_t)sizeof(int32_t)) != 0) {
        PyErr_Format(PyExc_ValueError,
                     "bp buffer (%zd bytes) is not a whole number of "
                     "int32 rows of ncells(%ld)=%zd",
                     bpbuf.len, n, ncells);
        goto fail;
    }
    B = bpbuf.len / (ncells * (Py_ssize_t)sizeof(int32_t));
    if (lengths_obj != Py_None) {
        if (PyObject_GetBuffer(lengths_obj, &lenbuf,
                               PyBUF_C_CONTIGUOUS | PyBUF_FORMAT) < 0)
            goto fail;
        if (lenbuf.format != NULL && strcmp(lenbuf.format, "i") != 0) {
            PyErr_Format(PyExc_TypeError,
                         "lengths must be int32, got format '%s'",
                         lenbuf.format);
            goto fail;
        }
        if (lenbuf.len != B * (Py_ssize_t)sizeof(int32_t)) {
            PyErr_Format(PyExc_ValueError,
                         "lengths buffer has %zd bytes, expected %zd "
                         "(B=%zd int32)",
                         lenbuf.len, B * (Py_ssize_t)sizeof(int32_t), B);
            goto fail;
        }
    }

    offs = (int64_t *)malloc(sizeof(int64_t) * (size_t)n);
    if (offs == NULL) {
        PyErr_NoMemory();
        goto fail;
    }
    for (level = 0; level < n; level++) {
        long rem = n - level;
        offs[level] = ncells - (int64_t)rem * (rem + 1) / 2;
    }

    trees = PyList_New(B);
    spans = PyList_New(B);
    if (trees == NULL || spans == NULL)
        goto fail;

    for (b = 0; b < B; b++) {
        DecodeCtx ctx;
        PyObject *tree;
        long m = n;

        if (lenbuf.obj != NULL)
            m = (long)((const int32_t *)lenbuf.buf)[b];
        if (m < 1 || m > n) {
            PyErr_Format(PyExc_ValueError,
                         "row %zd: length %ld outside [1, %ld]", b, m, n);
            goto fail;
        }
        ctx.bp = (const int32_t *)bpbuf.buf + b * ncells;
        ctx.offs = offs;
        ctx.spans = PyList_New(0);
        if (ctx.spans == NULL)
            goto fail;
        tree = build_node(&ctx, m - 1, 0);
        if (tree == NULL) {
            Py_DECREF(ctx.spans);
            goto fail;
        }
        PyList_SET_ITEM(trees, b, tree);      /* steals */
        PyList_SET_ITEM(spans, b, ctx.spans); /* steals */
    }

    out = PyTuple_Pack(2, trees, spans);
    /* fall through: cleanup below also serves the success path */
fail:
    Py_XDECREF(trees);
    Py_XDECREF(spans);
    free(offs);
    if (lenbuf.obj != NULL)
        PyBuffer_Release(&lenbuf);
    PyBuffer_Release(&bpbuf);
    return out;
}

static PyMethodDef methods[] = {
    {"decode_batch", decode_batch, METH_VARARGS,
     "decode_batch(bp, n, lengths=None) -> (trees, spans): batch CKY "
     "backpointer decode; see module docs."},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_fasttrees",
    "Batch CKY backpointer decode in C (host parse runtime).",
    -1, methods,
};

PyMODINIT_FUNC
PyInit__fasttrees(void)
{
    return PyModule_Create(&moduledef);
}
