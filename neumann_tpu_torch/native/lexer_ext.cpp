// CPython extension: native tokenizer for the query language.
//
// Produces the same Token stream as neumann_tpu/lang/lexer.py
// (kind/text/value/line/col NamedTuples) ~10x faster. Only ASCII
// sources take this path — the Python wrapper routes anything with
// non-ASCII bytes to the regex lexer so unicode identifier/column
// semantics stay exactly the reference's (neumann_parser/src/lexer.rs
// is the behavioral model).
//
// Tokens are constructed directly as tuple-subclass instances
// (tp_alloc + PyTuple_SET_ITEM), skipping the NamedTuple's Python
// __new__ — the single biggest cost in the Python loop.
//
// Lex errors raise ValueError with args (message, line, col); the
// wrapper re-raises ParseError.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <stdint.h>
#include <string.h>

static PyObject *g_token_cls;        // lang.lexer.Token (tuple subclass)
static PyObject *k_ident, *k_string, *k_number, *k_punct, *k_eof;
static PyObject *g_empty_str;

static int lex_err(const char *msg, Py_ssize_t line, Py_ssize_t col) {
    PyObject *args = Py_BuildValue("(snn)", msg, line, col);
    if (args) {
        PyErr_SetObject(PyExc_ValueError, args);
        Py_DECREF(args);
    }
    return 0;
}

// kind is borrowed; text and value are both STOLEN (callers passing
// the same object for both must hold two references).
static PyObject *make_token(PyObject *kind, PyObject *text,
                            PyObject *value, Py_ssize_t line,
                            Py_ssize_t col) {
    if (!text || !value) { Py_XDECREF(text); return NULL; }
    PyTypeObject *tp = (PyTypeObject *)g_token_cls;
    PyObject *t = tp->tp_alloc(tp, 5);
    if (!t) { Py_DECREF(text); Py_DECREF(value); return NULL; }
    PyObject *ln = PyLong_FromSsize_t(line);
    PyObject *cl = PyLong_FromSsize_t(col);
    if (!ln || !cl) {
        Py_XDECREF(ln); Py_XDECREF(cl);
        Py_DECREF(text); Py_DECREF(value); Py_DECREF(t);
        return NULL;
    }
    PyTuple_SET_ITEM(t, 0, Py_NewRef(kind));
    PyTuple_SET_ITEM(t, 1, text);
    PyTuple_SET_ITEM(t, 2, value);
    PyTuple_SET_ITEM(t, 3, ln);
    PyTuple_SET_ITEM(t, 4, cl);
    return t;
}

static inline int is_ident_start(unsigned char c) {
    return (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_';
}
static inline int is_ident_cont(unsigned char c) {
    return is_ident_start(c) || (c >= '0' && c <= '9');
}
static inline int is_digit(unsigned char c) {
    return c >= '0' && c <= '9';
}

// tokenize(src: str) -> list[Token]; src must be ASCII (wrapper checks)
static PyObject *py_tokenize(PyObject *self, PyObject *arg) {
    if (!PyUnicode_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return NULL;
    }
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return NULL;

    PyObject *out = PyList_New(0);
    if (!out) return NULL;

    Py_ssize_t pos = 0, line = 1, line_start = 0;
    while (pos < n) {
        unsigned char c = (unsigned char)s[pos];
        // whitespace
        if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            if (c == '\n') { line++; line_start = pos + 1; }
            pos++;
            continue;
        }
        // comment: -- to end of line
        if (c == '-' && pos + 1 < n && s[pos + 1] == '-') {
            pos += 2;
            while (pos < n && s[pos] != '\n') pos++;
            continue;
        }
        Py_ssize_t tok_line = line, tok_col = pos - line_start + 1;
        PyObject *tok = NULL;
        if (c == '\'') {
            // single-quoted string, '' escapes; no newline tracking
            // needed inside (ASCII source, quotes can span lines)
            Py_ssize_t p = pos + 1;
            int has_escape = 0;
            for (;;) {
                if (p >= n) {
                    lex_err("unterminated string", tok_line, tok_col);
                    goto fail;
                }
                if (s[p] == '\'') {
                    if (p + 1 < n && s[p + 1] == '\'') {
                        has_escape = 1;
                        p += 2;
                        continue;
                    }
                    break;
                }
                if (s[p] == '\n') { line++; line_start = p + 1; }
                p++;
            }
            PyObject *body;
            if (!has_escape) {
                body = PyUnicode_FromStringAndSize(s + pos + 1,
                                                   p - pos - 1);
            } else {
                // copy collapsing '' -> '
                Py_ssize_t blen = p - pos - 1;
                char *tmp = (char *)PyMem_Malloc(blen ? blen : 1);
                if (!tmp) { PyErr_NoMemory(); goto fail; }
                Py_ssize_t w = 0;
                for (Py_ssize_t i = pos + 1; i < p; i++) {
                    tmp[w++] = s[i];
                    if (s[i] == '\'' && i + 1 < p && s[i + 1] == '\'')
                        i++;
                }
                body = PyUnicode_FromStringAndSize(tmp, w);
                PyMem_Free(tmp);
            }
            if (!body) goto fail;
            Py_INCREF(body);   // text and value share the str: 2 refs
            tok = make_token(k_string, body, body, tok_line, tok_col);
            if (!tok) goto fail;
            pos = p + 1;
        } else if (is_digit(c)
                   || (c == '.' && pos + 1 < n && is_digit(
                           (unsigned char)s[pos + 1]))) {
            // number: \d+(\.\d*)?([eE][+-]?\d*)?  or  \.\d+(...)
            Py_ssize_t p = pos;
            int is_float = 0;
            while (p < n && is_digit((unsigned char)s[p])) p++;
            if (p < n && s[p] == '.') {
                // ".5" started with '.', or "1." trailing — both float
                is_float = 1;
                p++;
                while (p < n && is_digit((unsigned char)s[p])) p++;
            }
            if (p < n && (s[p] == 'e' || s[p] == 'E')) {
                is_float = 1;
                p++;
                if (p < n && (s[p] == '+' || s[p] == '-')) p++;
                Py_ssize_t dstart = p;
                while (p < n && is_digit((unsigned char)s[p])) p++;
                if (p == dstart) {
                    // "1e" / "2e+": one malformed number token,
                    // matching the regex lexer's greediness
                    char msg[64];
                    snprintf(msg, sizeof msg, "bad number '%.*s'",
                             (int)(p - pos < 40 ? p - pos : 40),
                             s + pos);
                    lex_err(msg, tok_line, tok_col);
                    goto fail;
                }
            }
            PyObject *text = PyUnicode_FromStringAndSize(s + pos,
                                                         p - pos);
            if (!text) goto fail;
            PyObject *value;
            if (is_float) {
                double d = PyOS_string_to_double(
                    PyUnicode_AsUTF8(text), NULL, NULL);
                if (d == -1.0 && PyErr_Occurred()) {
                    Py_DECREF(text);
                    PyErr_Clear();
                    lex_err("bad number", tok_line, tok_col);
                    goto fail;
                }
                value = PyFloat_FromDouble(d);
            } else {
                value = PyLong_FromString(PyUnicode_AsUTF8(text),
                                          NULL, 10);
            }
            if (!value) { Py_DECREF(text); goto fail; }
            tok = make_token(k_number, text, value, tok_line, tok_col);
            if (!tok) goto fail;
            pos = p;
        } else if (is_ident_start(c)) {
            Py_ssize_t p = pos + 1;
            while (p < n && is_ident_cont((unsigned char)s[p])) p++;
            PyObject *text = PyUnicode_FromStringAndSize(s + pos,
                                                         p - pos);
            if (!text) goto fail;
            Py_INCREF(text);
            tok = make_token(k_ident, text, text, tok_line, tok_col);
            if (!tok) goto fail;
            pos = p;
        } else {
            // punctuation: two-char first (-> <= >= != <>)
            Py_ssize_t plen = 0;
            if (pos + 1 < n) {
                char d = s[pos + 1];
                if ((c == '-' && d == '>') || (c == '<' && d == '=')
                        || (c == '>' && d == '=')
                        || (c == '!' && d == '=')
                        || (c == '<' && d == '>'))
                    plen = 2;
            }
            if (!plen && strchr("()[]{},:;=<>*.+-/%", c) && c != '\0')
                plen = 1;
            if (!plen) {
                char msg[48];
                snprintf(msg, sizeof msg, "unexpected character '%c'",
                         c);
                lex_err(msg, tok_line, tok_col);
                goto fail;
            }
            PyObject *text = PyUnicode_FromStringAndSize(s + pos, plen);
            if (!text) goto fail;
            Py_INCREF(text);
            tok = make_token(k_punct, text, text, tok_line, tok_col);
            if (!tok) goto fail;
            pos += plen;
        }
        if (PyList_Append(out, tok) != 0) { Py_DECREF(tok); goto fail; }
        Py_DECREF(tok);
    }
    {
        PyObject *eof = make_token(k_eof, Py_NewRef(g_empty_str),
                                   Py_NewRef(Py_None), line,
                                   pos - line_start + 1);
        if (!eof || PyList_Append(out, eof) != 0) {
            Py_XDECREF(eof);
            goto fail;
        }
        Py_DECREF(eof);
    }
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

// shape(src) -> (key_tuple, vals_list): the parameterized-statement
// shape key in ONE pass with zero Token objects. Literal tokens
// contribute a type marker ("\x00i"/"\x00f"/"\x00s") to the key and
// their value to vals; everything else contributes its text. Lex
// errors raise the same ValueError triple as tokenize.
static PyObject *k_mark_i, *k_mark_f, *k_mark_s;

static PyObject *py_shape(PyObject *self, PyObject *arg) {
    if (!PyUnicode_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "expected str");
        return NULL;
    }
    Py_ssize_t n;
    const char *s = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!s) return NULL;
    PyObject *key = PyList_New(0);
    PyObject *vals = PyList_New(0);
    if (!key || !vals) { Py_XDECREF(key); Py_XDECREF(vals); return NULL; }

    Py_ssize_t pos = 0, line = 1, line_start = 0;
    while (pos < n) {
        unsigned char c = (unsigned char)s[pos];
        if (c == ' ' || c == '\t' || c == '\r' || c == '\n') {
            if (c == '\n') { line++; line_start = pos + 1; }
            pos++;
            continue;
        }
        if (c == '-' && pos + 1 < n && s[pos + 1] == '-') {
            pos += 2;
            while (pos < n && s[pos] != '\n') pos++;
            continue;
        }
        Py_ssize_t tok_line = line, tok_col = pos - line_start + 1;
        if (c == '\'') {
            Py_ssize_t p = pos + 1;
            int has_escape = 0;
            for (;;) {
                if (p >= n) {
                    lex_err("unterminated string", tok_line, tok_col);
                    goto fail;
                }
                if (s[p] == '\'') {
                    if (p + 1 < n && s[p + 1] == '\'') {
                        has_escape = 1;
                        p += 2;
                        continue;
                    }
                    break;
                }
                if (s[p] == '\n') { line++; line_start = p + 1; }
                p++;
            }
            PyObject *body;
            if (!has_escape) {
                body = PyUnicode_FromStringAndSize(s + pos + 1,
                                                   p - pos - 1);
            } else {
                Py_ssize_t blen = p - pos - 1;
                char *tmp = (char *)PyMem_Malloc(blen ? blen : 1);
                if (!tmp) { PyErr_NoMemory(); goto fail; }
                Py_ssize_t w = 0;
                for (Py_ssize_t i = pos + 1; i < p; i++) {
                    tmp[w++] = s[i];
                    if (s[i] == '\'' && i + 1 < p && s[i + 1] == '\'')
                        i++;
                }
                body = PyUnicode_FromStringAndSize(tmp, w);
                PyMem_Free(tmp);
            }
            if (!body) goto fail;
            if (PyList_Append(key, k_mark_s) != 0
                || PyList_Append(vals, body) != 0) {
                Py_DECREF(body);
                goto fail;
            }
            Py_DECREF(body);
            pos = p + 1;
        } else if (is_digit(c)
                   || (c == '.' && pos + 1 < n && is_digit(
                           (unsigned char)s[pos + 1]))) {
            Py_ssize_t p = pos;
            int is_float = 0;
            while (p < n && is_digit((unsigned char)s[p])) p++;
            if (p < n && s[p] == '.') {
                is_float = 1;
                p++;
                while (p < n && is_digit((unsigned char)s[p])) p++;
            }
            if (p < n && (s[p] == 'e' || s[p] == 'E')) {
                is_float = 1;
                p++;
                if (p < n && (s[p] == '+' || s[p] == '-')) p++;
                Py_ssize_t dstart = p;
                while (p < n && is_digit((unsigned char)s[p])) p++;
                if (p == dstart) {
                    lex_err("bad number", tok_line, tok_col);
                    goto fail;
                }
            }
            char buf[64];
            Py_ssize_t tl = p - pos;
            PyObject *value = NULL;
            if (tl < (Py_ssize_t)sizeof(buf)) {
                memcpy(buf, s + pos, tl);
                buf[tl] = 0;
                value = is_float
                    ? PyFloat_FromDouble(
                          PyOS_string_to_double(buf, NULL, NULL))
                    : PyLong_FromString(buf, NULL, 10);
            }
            if (!value) goto fail;
            if (PyList_Append(key, is_float ? k_mark_f : k_mark_i) != 0
                || PyList_Append(vals, value) != 0) {
                Py_DECREF(value);
                goto fail;
            }
            Py_DECREF(value);
            pos = p;
        } else if (is_ident_start(c)) {
            Py_ssize_t p = pos + 1;
            while (p < n && is_ident_cont((unsigned char)s[p])) p++;
            PyObject *text = PyUnicode_FromStringAndSize(s + pos,
                                                         p - pos);
            if (!text || PyList_Append(key, text) != 0) {
                Py_XDECREF(text);
                goto fail;
            }
            Py_DECREF(text);
            pos = p;
        } else {
            Py_ssize_t plen = 0;
            if (pos + 1 < n) {
                char d = s[pos + 1];
                if ((c == '-' && d == '>') || (c == '<' && d == '=')
                        || (c == '>' && d == '=')
                        || (c == '!' && d == '=')
                        || (c == '<' && d == '>'))
                    plen = 2;
            }
            if (!plen && strchr("()[]{},:;=<>*.+-/%", c) && c != '\0')
                plen = 1;
            if (!plen) {
                lex_err("unexpected character", tok_line, tok_col);
                goto fail;
            }
            PyObject *text = PyUnicode_FromStringAndSize(s + pos, plen);
            if (!text || PyList_Append(key, text) != 0) {
                Py_XDECREF(text);
                goto fail;
            }
            Py_DECREF(text);
            pos += plen;
        }
    }
    {
        PyObject *ktup = PyList_AsTuple(key);
        Py_DECREF(key);
        if (!ktup) { Py_DECREF(vals); return NULL; }
        return Py_BuildValue("(NN)", ktup, vals);
    }
fail:
    Py_DECREF(key);
    Py_DECREF(vals);
    return NULL;
}

static PyObject *py_init(PyObject *self, PyObject *arg) {
    Py_XSETREF(g_token_cls, Py_NewRef(arg));
    Py_RETURN_NONE;
}

static PyMethodDef methods[] = {
    {"init", py_init, METH_O, "init(Token_class)"},
    {"tokenize", py_tokenize, METH_O, NULL},
    {"shape", py_shape, METH_O, NULL},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_neumann_lexer",
    "Native tokenizer for the query language.", -1, methods,
};

extern "C" PyMODINIT_FUNC PyInit__neumann_lexer(void) {
    // NB: explicit lengths — the markers start with a NUL byte
    k_mark_i = PyUnicode_FromStringAndSize("\x00i", 2);
    k_mark_f = PyUnicode_FromStringAndSize("\x00f", 2);
    k_mark_s = PyUnicode_FromStringAndSize("\x00s", 2);
    k_ident = PyUnicode_InternFromString("ident");
    k_string = PyUnicode_InternFromString("string");
    k_number = PyUnicode_InternFromString("number");
    k_punct = PyUnicode_InternFromString("punct");
    k_eof = PyUnicode_InternFromString("eof");
    g_empty_str = PyUnicode_InternFromString("");
    return PyModule_Create(&moddef);
}
