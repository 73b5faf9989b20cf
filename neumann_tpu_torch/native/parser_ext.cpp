// CPython extension: native fast-path parser for the query language.
//
// Parses the HOT statement shapes (SELECT / INSERT ... VALUES /
// SIMILAR) straight from the source bytes and builds the same
// lang.ast dataclass objects the Python parser produces — slot-filled
// via member-descriptor offsets, bypassing dataclass __init__.
// Anything outside the supported subset (joins, GROUP BY, arithmetic
// expressions, subqueries, non-ASCII input, graph/vault statements…)
// returns None WITHOUT error and the caller falls back to the Python
// parser, which either handles it or raises the canonical ParseError.
//
// Parity target: neumann_parser/src/{lexer,parser}.rs reaches 1.9M
// queries/s in native Rust; the Python recursive-descent parser is
// ~100K/s cold. This fast path exists for the same reason the
// reference's parser is native: cold parse sits on the serving loop
// for novel statements. Differential tests in
// tests/test_native_parser.py assert AST equality vs the Python
// parser over the supported grammar.
//
// Built at first use by neumann_tpu/native/pyparser.py with
//   g++ -O3 -shared -fPIC -I<python-include> parser_ext.cpp

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <structmember.h>

#include <stdint.h>
#include <stdlib.h>
#include <errno.h>
#include <string.h>

// ---------------------------------------------------------------------------
// class registry (filled by init_parser)
// ---------------------------------------------------------------------------

enum { C_SELECT, C_SELECTITEM, C_INSERT, C_SIMILAR, C_CONDITION,
       C_NODECREATE, C_FIND, C_UPDATE, C_DELETE, C_EMBEDSTORE,
       C_EMBEDGET, C_EMBEDDELETE, C_N };
#define MAX_FIELDS 12

// Exact field count each construction site fills (make_obj writes
// g_nf slots from a fixed-size stack array — a dataclass that gained
// a field would otherwise read past the array: stack garbage stored
// as a PyObject*). init_parser refuses a class whose field count
// drifts from this table, so grammar additions degrade to the Python
// fallback instead of corrupting memory.
static const int g_want_nf[C_N] = {
    /* Select */ 10, /* SelectItem */ 5, /* Insert */ 4,
    /* Similar */ 7, /* Condition */ 6, /* NodeCreate */ 2,
    /* Find */ 10, /* Update */ 3, /* Delete */ 2,
    /* EmbedStore */ 3, /* EmbedGet */ 2, /* EmbedDelete */ 2};

static PyObject *g_cls[C_N];
static int g_nf[C_N];
static Py_ssize_t g_off[C_N][MAX_FIELDS];
static int g_ready = 0;

// Python fallback parser (lang.parser's pure-Python path); parse_full
// delegates unsupported statements to it so the module-level parse can
// BE the C function (no Python wrapper frame on the hot path)
static PyObject *g_fallback = NULL;

// interned constants
static PyObject *s_star;            // "*"
static PyObject *s_ops[16];         // condition op strings
enum { OP_EQ, OP_NE, OP_LT, OP_LE, OP_GT, OP_GE, OP_AND, OP_OR, OP_NOT,
       OP_IN, OP_LIKE, OP_ISNULL, OP_ISNOTNULL, OP_NOPS };

// build an instance of g_cls[ci] with vals[0..g_nf) — steals every ref
static PyObject *make_obj(int ci, PyObject **vals) {
    PyTypeObject *tp = (PyTypeObject *)g_cls[ci];
    PyObject *o = tp->tp_alloc(tp, 0);
    if (!o) {
        for (int i = 0; i < g_nf[ci]; i++) Py_XDECREF(vals[i]);
        return NULL;
    }
    for (int i = 0; i < g_nf[ci]; i++)
        *(PyObject **)((char *)o + g_off[ci][i]) = vals[i];
    return o;
}

// ---------------------------------------------------------------------------
// tokenizer
// ---------------------------------------------------------------------------

enum { TK_EOF = 0, TK_IDENT, TK_STRING, TK_NUMBER, TK_PUNCT };

typedef struct {
    uint8_t kind;
    uint32_t start;   // byte offset into src
    uint32_t len;
} Tk;

#define MAX_TOKS 4096

typedef struct {
    const char *src;
    Py_ssize_t n;
    Tk toks[MAX_TOKS];
    int ntok;
    int pos;          // parser cursor
    int fb;           // fallback flag (unsupported / malformed)
} P;

static int lex_all(P *p) {
    const char *s = p->src;
    Py_ssize_t n = p->n, i = 0;
    int t = 0;
    while (i < n) {
        unsigned char c = (unsigned char)s[i];
        if (c >= 0x80) return -1;                 // non-ASCII: fallback
        if (c == ' ' || c == '\t' || c == '\r' || c == '\n') { i++; continue; }
        if (c == '-' && i + 1 < n && s[i + 1] == '-') {   // comment
            while (i < n && s[i] != '\n') i++;
            continue;
        }
        if (t >= MAX_TOKS - 1) return -1;
        if (c == '\'') {                          // string w/ '' escape
            Py_ssize_t j = i + 1;
            for (;;) {
                if (j >= n) return -1;            // unterminated
                if (s[j] == '\'') {
                    if (j + 1 < n && s[j + 1] == '\'') { j += 2; continue; }
                    break;
                }
                if ((unsigned char)s[j] >= 0x80) return -1;
                j++;
            }
            p->toks[t].kind = TK_STRING;
            p->toks[t].start = (uint32_t)(i + 1);
            p->toks[t].len = (uint32_t)(j - i - 1);
            t++;
            i = j + 1;
            continue;
        }
        if ((c >= '0' && c <= '9') ||
            (c == '.' && i + 1 < n && s[i + 1] >= '0' && s[i + 1] <= '9')) {
            Py_ssize_t j = i;
            while (j < n && s[j] >= '0' && s[j] <= '9') j++;
            if (j < n && s[j] == '.') {
                j++;
                while (j < n && s[j] >= '0' && s[j] <= '9') j++;
            }
            if (j < n && (s[j] == 'e' || s[j] == 'E')) {
                j++;
                if (j < n && (s[j] == '+' || s[j] == '-')) j++;
                Py_ssize_t d0 = j;
                while (j < n && s[j] >= '0' && s[j] <= '9') j++;
                if (j == d0) return -1;           // "1e" — let Python raise
            }
            p->toks[t].kind = TK_NUMBER;
            p->toks[t].start = (uint32_t)i;
            p->toks[t].len = (uint32_t)(j - i);
            t++;
            i = j;
            continue;
        }
        if ((c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z') || c == '_') {
            Py_ssize_t j = i + 1;
            while (j < n) {
                unsigned char d = (unsigned char)s[j];
                if ((d >= 'a' && d <= 'z') || (d >= 'A' && d <= 'Z') ||
                    (d >= '0' && d <= '9') || d == '_')
                    j++;
                else
                    break;
            }
            p->toks[t].kind = TK_IDENT;
            p->toks[t].start = (uint32_t)i;
            p->toks[t].len = (uint32_t)(j - i);
            t++;
            i = j;
            continue;
        }
        // punct (2-char first)
        if (i + 1 < n) {
            char a = s[i], b = s[i + 1];
            if ((a == '-' && b == '>') || (a == '<' && b == '=') ||
                (a == '>' && b == '=') || (a == '!' && b == '=') ||
                (a == '<' && b == '>')) {
                p->toks[t].kind = TK_PUNCT;
                p->toks[t].start = (uint32_t)i;
                p->toks[t].len = 2;
                t++;
                i += 2;
                continue;
            }
        }
        if (strchr("()[]{},:;=<>*.+-/%", c) != NULL) {
            p->toks[t].kind = TK_PUNCT;
            p->toks[t].start = (uint32_t)i;
            p->toks[t].len = 1;
            t++;
            i++;
            continue;
        }
        return -1;                                // unknown char
    }
    p->toks[t].kind = TK_EOF;
    p->toks[t].start = (uint32_t)n;
    p->toks[t].len = 0;
    p->ntok = t + 1;
    p->pos = 0;
    p->fb = 0;
    return 0;
}

// --- token helpers ---------------------------------------------------------

static inline Tk *cur(P *p) { return &p->toks[p->pos]; }
static inline Tk *peek1(P *p) {
    return &p->toks[p->pos + 1 < p->ntok ? p->pos + 1 : p->ntok - 1];
}
static inline void adv(P *p) { if (p->pos < p->ntok - 1) p->pos++; }

static inline int tk_text_is(P *p, Tk *t, const char *lit) {
    size_t ln = strlen(lit);
    return t->len == ln && memcmp(p->src + t->start, lit, ln) == 0;
}

// case-insensitive keyword compare (lit must be UPPERCASE)
static inline int tk_kw(P *p, Tk *t, const char *lit) {
    if (t->kind != TK_IDENT) return 0;
    size_t ln = strlen(lit);
    if (t->len != ln) return 0;
    const char *s = p->src + t->start;
    for (size_t i = 0; i < ln; i++) {
        char c = s[i];
        if (c >= 'a' && c <= 'z') c -= 32;
        if (c != lit[i]) return 0;
    }
    return 1;
}

static inline int at_punct(P *p, const char *lit) {
    Tk *t = cur(p);
    return t->kind == TK_PUNCT && tk_text_is(p, t, lit);
}

static inline int accept_punct(P *p, const char *lit) {
    if (at_punct(p, lit)) { adv(p); return 1; }
    return 0;
}

static inline int accept_kw(P *p, const char *lit) {
    if (tk_kw(p, cur(p), lit)) { adv(p); return 1; }
    return 0;
}

static inline int expect_punct(P *p, const char *lit) {
    if (!accept_punct(p, lit)) { p->fb = 1; return 0; }
    return 1;
}

static inline int expect_kw(P *p, const char *lit) {
    if (!accept_kw(p, lit)) { p->fb = 1; return 0; }
    return 1;
}

// --- token -> PyObject -----------------------------------------------------

// direct-mapped identifier cache: table/column names repeat across
// statements, so reuse one unicode object per name instead of
// allocating a fresh one every parse (GIL held throughout; bounded)
#define STRCACHE_SZ 512
static PyObject *g_strs[STRCACHE_SZ];

static PyObject *cached_str(const char *s, Py_ssize_t len) {
    if (len == 0 || len > 64)
        return PyUnicode_FromStringAndSize(s, len);
    uint32_t h = 2166136261u;
    for (Py_ssize_t i = 0; i < len; i++)
        h = (h ^ (uint8_t)s[i]) * 16777619u;
    PyObject **slot = &g_strs[h & (STRCACHE_SZ - 1)];
    PyObject *c = *slot;
    if (c) {
        Py_ssize_t cl;
        const char *cs = PyUnicode_AsUTF8AndSize(c, &cl);
        if (cs && cl == len && memcmp(cs, s, len) == 0)
            return Py_NewRef(c);
    }
    PyObject *o = PyUnicode_FromStringAndSize(s, len);
    if (o)
        Py_XSETREF(*slot, Py_NewRef(o));
    return o;
}

static PyObject *tok_str(P *p, Tk *t) {   // raw text, new ref
    return cached_str(p->src + t->start, t->len);
}

static PyObject *dec_string(P *p, Tk *t) {
    const char *s = p->src + t->start;
    if (memchr(s, '\'', t->len) == NULL)
        return PyUnicode_FromStringAndSize(s, t->len);
    char *buf = (char *)PyMem_Malloc(t->len ? t->len : 1);
    if (!buf) return PyErr_NoMemory();
    uint32_t o = 0;
    for (uint32_t i = 0; i < t->len; i++) {
        buf[o++] = s[i];
        if (s[i] == '\'') i++;          // collapse '' -> '
    }
    PyObject *r = PyUnicode_FromStringAndSize(buf, o);
    PyMem_Free(buf);
    return r;
}

static PyObject *dec_number(P *p, Tk *t, int *is_int) {
    char buf[64];
    if (t->len >= sizeof(buf)) { p->fb = 1; return NULL; }
    memcpy(buf, p->src + t->start, t->len);
    buf[t->len] = 0;
    int flt = 0;
    for (uint32_t i = 0; i < t->len; i++)
        if (buf[i] == '.' || buf[i] == 'e' || buf[i] == 'E') { flt = 1; break; }
    if (!flt) {
        errno = 0;
        char *end = NULL;
        long long v = strtoll(buf, &end, 10);
        if (errno == ERANGE || end != buf + t->len) { p->fb = 1; return NULL; }
        if (is_int) *is_int = 1;
        return PyLong_FromLongLong(v);
    }
    char *end = NULL;
    double d = strtod(buf, &end);
    if (end != buf + t->len) { p->fb = 1; return NULL; }
    if (is_int) *is_int = 0;
    return PyFloat_FromDouble(d);
}

// dotted identifier: ident (. ident)* — joined with '.'
static PyObject *dotted_ident(P *p) {
    Tk *t = cur(p);
    if (t->kind != TK_IDENT) { p->fb = 1; return NULL; }
    char buf[256];
    uint32_t o = 0;
    if (t->len >= sizeof(buf)) { p->fb = 1; return NULL; }
    memcpy(buf, p->src + t->start, t->len);
    o = t->len;
    adv(p);
    while (at_punct(p, ".")) {
        adv(p);
        t = cur(p);
        if (t->kind != TK_IDENT) { p->fb = 1; return NULL; }
        if (o + 1 + t->len >= sizeof(buf)) { p->fb = 1; return NULL; }
        buf[o++] = '.';
        memcpy(buf + o, p->src + t->start, t->len);
        o += t->len;
        adv(p);
    }
    return cached_str(buf, o);
}

// ---------------------------------------------------------------------------
// values
// ---------------------------------------------------------------------------

static PyObject *parse_vector(P *p);   // fwd

// mirrors _Parser.value(): string | [-]number | [vector] | TRUE/FALSE/NULL
// | bare ident as string
static PyObject *parse_value(P *p) {
    Tk *t = cur(p);
    if (t->kind == TK_STRING) { adv(p); return dec_string(p, t); }
    if (t->kind == TK_NUMBER) { adv(p); return dec_number(p, t, NULL); }
    if (t->kind == TK_PUNCT && tk_text_is(p, t, "-")) {
        adv(p);
        t = cur(p);
        if (t->kind != TK_NUMBER) { p->fb = 1; return NULL; }
        adv(p);
        PyObject *v = dec_number(p, t, NULL);
        if (!v) return NULL;
        PyObject *neg = PyNumber_Negative(v);
        Py_DECREF(v);
        return neg;
    }
    if (t->kind == TK_PUNCT && tk_text_is(p, t, "["))
        return parse_vector(p);
    if (t->kind == TK_IDENT) {
        if (tk_kw(p, t, "TRUE")) { adv(p); Py_RETURN_TRUE; }
        if (tk_kw(p, t, "FALSE")) { adv(p); Py_RETURN_FALSE; }
        if (tk_kw(p, t, "NULL")) { adv(p); Py_RETURN_NONE; }
        adv(p);
        return tok_str(p, t);           // bare identifier as string value
    }
    p->fb = 1;
    return NULL;
}

static PyObject *parse_vector(P *p) {
    if (!expect_punct(p, "[")) return NULL;
    PyObject *out = PyList_New(0);
    if (!out) return NULL;
    if (!at_punct(p, "]")) {
        for (;;) {
            int neg = accept_punct(p, "-");
            Tk *t = cur(p);
            if (t->kind != TK_NUMBER) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *v = dec_number(p, t, NULL);
            if (!v) goto fail;
            double d = PyFloat_Check(v) ? PyFloat_AS_DOUBLE(v)
                                        : (double)PyLong_AsLongLong(v);
            Py_DECREF(v);
            PyObject *f = PyFloat_FromDouble(neg ? -d : d);
            if (!f || PyList_Append(out, f) != 0) { Py_XDECREF(f); goto fail; }
            Py_DECREF(f);
            if (!accept_punct(p, ",")) break;
        }
    }
    if (!expect_punct(p, "]")) goto fail;
    return out;
fail:
    Py_DECREF(out);
    return NULL;
}

// ---------------------------------------------------------------------------
// conditions (Condition fields: op, column, value, left, right, expr)
// ---------------------------------------------------------------------------

static PyObject *cond_new(PyObject *op /*borrowed*/, PyObject *column,
                          PyObject *value, PyObject *left,
                          PyObject *right) {
    // column/value/left/right are STOLEN (may be NULL -> None)
    PyObject *vals[6];
    Py_INCREF(op);
    vals[0] = op;
    vals[1] = column ? column : Py_NewRef(Py_None);
    vals[2] = value ? value : Py_NewRef(Py_None);
    vals[3] = left ? left : Py_NewRef(Py_None);
    vals[4] = right ? right : Py_NewRef(Py_None);
    vals[5] = Py_NewRef(Py_None);     // expr
    return make_obj(C_CONDITION, vals);
}

static PyObject *parse_or(P *p);

// [NOT] IN / [NOT] LIKE / IS [NOT] NULL / BETWEEN / cmp value
static PyObject *parse_primary_cond(P *p) {
    if (accept_punct(p, "(")) {
        // subquery (SELECT …) unsupported -> fb handled by parse_or path
        PyObject *c = parse_or(p);
        if (!c) return NULL;
        if (!expect_punct(p, ")")) { Py_DECREF(c); return NULL; }
        return c;
    }
    Tk *t = cur(p);
    if (t->kind != TK_IDENT) { p->fb = 1; return NULL; }
    if (tk_kw(p, t, "EXISTS")) { p->fb = 1; return NULL; }   // subquery
    // aggregate call in condition (HAVING) unsupported
    if (peek1(p)->kind == TK_PUNCT && tk_text_is(p, peek1(p), "(")) {
        p->fb = 1;
        return NULL;
    }
    PyObject *col = dotted_ident(p);
    if (!col) return NULL;
    if (accept_kw(p, "IS")) {
        int not_ = accept_kw(p, "NOT");
        if (!expect_kw(p, "NULL")) { Py_DECREF(col); return NULL; }
        return cond_new(s_ops[not_ ? OP_ISNOTNULL : OP_ISNULL], col,
                        NULL, NULL, NULL);
    }
    int negate = 0;
    if (accept_kw(p, "NOT")) {
        negate = 1;
        if (!tk_kw(p, cur(p), "IN") && !tk_kw(p, cur(p), "LIKE")) {
            p->fb = 1;                 // Python raises here; same text
            Py_DECREF(col);
            return NULL;
        }
    }
    PyObject *inner = NULL;
    if (accept_kw(p, "IN")) {
        if (!expect_punct(p, "(")) { Py_DECREF(col); return NULL; }
        if (tk_kw(p, cur(p), "SELECT")) {   // IN (SELECT …) -> fallback
            p->fb = 1;
            Py_DECREF(col);
            return NULL;
        }
        PyObject *vals = PyList_New(0);
        if (!vals) { Py_DECREF(col); return NULL; }
        for (;;) {
            PyObject *v = parse_value(p);
            if (!v) { Py_DECREF(vals); Py_DECREF(col); return NULL; }
            if (PyList_Append(vals, v) != 0) {
                Py_DECREF(v); Py_DECREF(vals); Py_DECREF(col);
                return NULL;
            }
            Py_DECREF(v);
            if (!accept_punct(p, ",")) break;
        }
        if (!expect_punct(p, ")")) {
            Py_DECREF(vals); Py_DECREF(col);
            return NULL;
        }
        PyObject *tup = PyList_AsTuple(vals);
        Py_DECREF(vals);
        if (!tup) { Py_DECREF(col); return NULL; }
        inner = cond_new(s_ops[OP_IN], col, tup, NULL, NULL);
    } else if (accept_kw(p, "LIKE")) {
        Tk *st = cur(p);
        if (st->kind != TK_STRING) { p->fb = 1; Py_DECREF(col); return NULL; }
        adv(p);
        PyObject *pat = dec_string(p, st);
        if (!pat) { Py_DECREF(col); return NULL; }
        inner = cond_new(s_ops[OP_LIKE], col, pat, NULL, NULL);
    } else if (accept_kw(p, "BETWEEN")) {
        PyObject *lo = parse_value(p);
        if (!lo) { Py_DECREF(col); return NULL; }
        if (!expect_kw(p, "AND")) {
            Py_DECREF(lo); Py_DECREF(col);
            return NULL;
        }
        PyObject *hi = parse_value(p);
        if (!hi) { Py_DECREF(lo); Py_DECREF(col); return NULL; }
        PyObject *lc = cond_new(s_ops[OP_GE], Py_NewRef(col), lo, NULL,
                                NULL);
        PyObject *rc = lc ? cond_new(s_ops[OP_LE], col, hi, NULL, NULL)
                          : (Py_DECREF(col), Py_DECREF(hi), (PyObject *)NULL);
        if (!lc || !rc) { Py_XDECREF(lc); Py_XDECREF(rc); return NULL; }
        return cond_new(s_ops[OP_AND], NULL, NULL, lc, rc);
    } else {
        Tk *op = cur(p);
        int oi = -1;
        if (op->kind == TK_PUNCT) {
            if (tk_text_is(p, op, "=")) oi = OP_EQ;
            else if (tk_text_is(p, op, "!=") || tk_text_is(p, op, "<>"))
                oi = OP_NE;
            else if (tk_text_is(p, op, "<")) oi = OP_LT;
            else if (tk_text_is(p, op, "<=")) oi = OP_LE;
            else if (tk_text_is(p, op, ">")) oi = OP_GT;
            else if (tk_text_is(p, op, ">=")) oi = OP_GE;
        }
        if (oi < 0) { p->fb = 1; Py_DECREF(col); return NULL; }
        adv(p);
        // arithmetic RHS: value followed by an arith op, or '(' — fallback
        Tk *v1 = cur(p), *v2 = peek1(p);
        if (v1->kind == TK_PUNCT && tk_text_is(p, v1, "(")) {
            p->fb = 1; Py_DECREF(col); return NULL;
        }
        if ((v1->kind == TK_NUMBER || v1->kind == TK_IDENT) &&
            v2->kind == TK_PUNCT && v2->len == 1 &&
            strchr("+-*/%", p->src[v2->start]) != NULL) {
            p->fb = 1; Py_DECREF(col); return NULL;
        }
        PyObject *v = parse_value(p);
        if (!v) { Py_DECREF(col); return NULL; }
        inner = cond_new(s_ops[oi], col, v, NULL, NULL);
    }
    if (!inner) return NULL;
    if (negate) {
        PyObject *n = cond_new(s_ops[OP_NOT], NULL, NULL, inner, NULL);
        return n;
    }
    return inner;
}

static PyObject *parse_not(P *p) {
    if (accept_kw(p, "NOT")) {
        PyObject *c = parse_not(p);
        if (!c) return NULL;
        return cond_new(s_ops[OP_NOT], NULL, NULL, c, NULL);
    }
    return parse_primary_cond(p);
}

static PyObject *parse_and(P *p) {
    PyObject *left = parse_not(p);
    if (!left) return NULL;
    while (accept_kw(p, "AND")) {
        PyObject *right = parse_not(p);
        if (!right) { Py_DECREF(left); return NULL; }
        PyObject *c = cond_new(s_ops[OP_AND], NULL, NULL, left, right);
        if (!c) return NULL;
        left = c;
    }
    return left;
}

static PyObject *parse_or(P *p) {
    PyObject *left = parse_and(p);
    if (!left) return NULL;
    while (accept_kw(p, "OR")) {
        PyObject *right = parse_and(p);
        if (!right) { Py_DECREF(left); return NULL; }
        PyObject *c = cond_new(s_ops[OP_OR], NULL, NULL, left, right);
        if (!c) return NULL;
        left = c;
    }
    return left;
}

// ---------------------------------------------------------------------------
// SELECT
// ---------------------------------------------------------------------------

static const char *AGGS[] = {"COUNT", "SUM", "AVG", "MIN", "MAX", NULL};

// SelectItem fields: expr, agg, alias, tree, distinct
static PyObject *parse_select_item(P *p) {
    if (at_punct(p, "*")) {
        adv(p);
        PyObject *vals[5] = {Py_NewRef(s_star), Py_NewRef(Py_None),
                             Py_NewRef(Py_None), Py_NewRef(Py_None),
                             Py_NewRef(Py_False)};
        return make_obj(C_SELECTITEM, vals);
    }
    Tk *t = cur(p);
    if (t->kind != TK_IDENT) { p->fb = 1; return NULL; }
    // aggregate?
    for (int a = 0; AGGS[a]; a++) {
        if (tk_kw(p, t, AGGS[a]) && peek1(p)->kind == TK_PUNCT &&
            tk_text_is(p, peek1(p), "(")) {
            adv(p);
            adv(p);
            int agg_distinct = accept_kw(p, "DISTINCT");
            PyObject *arg;
            if (accept_punct(p, "*")) {
                if (agg_distinct) { p->fb = 1; return NULL; }
                arg = Py_NewRef(s_star);
            } else {
                arg = dotted_ident(p);
                if (!arg) return NULL;
            }
            if (!expect_punct(p, ")")) { Py_DECREF(arg); return NULL; }
            PyObject *alias = NULL;
            if (accept_kw(p, "AS")) {
                Tk *al = cur(p);
                if (al->kind != TK_IDENT) {
                    p->fb = 1; Py_DECREF(arg);
                    return NULL;
                }
                adv(p);
                alias = tok_str(p, al);
                if (!alias) { Py_DECREF(arg); return NULL; }
            }
            char low[8];
            size_t ln = strlen(AGGS[a]);
            for (size_t i = 0; i <= ln; i++) {
                char c = AGGS[a][i];
                low[i] = (c >= 'A' && c <= 'Z') ? c + 32 : c;
            }
            PyObject *agg = PyUnicode_FromString(low);
            if (!agg) { Py_DECREF(arg); Py_XDECREF(alias); return NULL; }
            PyObject *vals[5] = {
                arg, agg, alias ? alias : Py_NewRef(Py_None),
                Py_NewRef(Py_None),
                Py_NewRef(agg_distinct ? Py_True : Py_False)};
            return make_obj(C_SELECTITEM, vals);
        }
    }
    PyObject *name = dotted_ident(p);
    if (!name) return NULL;
    // arithmetic expression items fall back ('(' handled above via fb)
    Tk *nx = cur(p);
    if (nx->kind == TK_PUNCT && nx->len == 1 &&
        strchr("+-*/%(", p->src[nx->start]) != NULL) {
        p->fb = 1;
        Py_DECREF(name);
        return NULL;
    }
    PyObject *alias = NULL;
    if (accept_kw(p, "AS")) {
        Tk *al = cur(p);
        if (al->kind != TK_IDENT) { p->fb = 1; Py_DECREF(name); return NULL; }
        adv(p);
        alias = tok_str(p, al);
        if (!alias) { Py_DECREF(name); return NULL; }
    }
    PyObject *vals[5] = {name, Py_NewRef(Py_None),
                         alias ? alias : Py_NewRef(Py_None),
                         Py_NewRef(Py_None), Py_NewRef(Py_False)};
    return make_obj(C_SELECTITEM, vals);
}

// Select fields: table, items, where, joins, group_by, having, order_by,
//                limit, offset, distinct
static PyObject *parse_select(P *p) {
    int distinct = accept_kw(p, "DISTINCT");
    PyObject *items = PyList_New(0);
    if (!items) return NULL;
    for (;;) {
        PyObject *it = parse_select_item(p);
        if (!it) { Py_DECREF(items); return NULL; }
        if (PyList_Append(items, it) != 0) {
            Py_DECREF(it); Py_DECREF(items);
            return NULL;
        }
        Py_DECREF(it);
        if (!accept_punct(p, ",")) break;
    }
    if (!expect_kw(p, "FROM")) { Py_DECREF(items); return NULL; }
    Tk *tt = cur(p);
    if (tt->kind != TK_IDENT) { p->fb = 1; Py_DECREF(items); return NULL; }
    adv(p);
    PyObject *table = tok_str(p, tt);
    if (!table) { Py_DECREF(items); return NULL; }
    // table alias / JOIN / GROUP BY -> fallback: next token must be one of
    // WHERE ORDER LIMIT OFFSET ; EOF
    PyObject *where = NULL;
    PyObject *order_by = NULL;
    PyObject *limit = NULL;
    long long offset = 0;
    Tk *nx = cur(p);
    if (!(nx->kind == TK_EOF ||
          (nx->kind == TK_PUNCT && tk_text_is(p, nx, ";")) ||
          tk_kw(p, nx, "WHERE") || tk_kw(p, nx, "ORDER") ||
          tk_kw(p, nx, "LIMIT") || tk_kw(p, nx, "OFFSET"))) {
        p->fb = 1;
        goto fail;
    }
    if (accept_kw(p, "WHERE")) {
        where = parse_or(p);
        if (!where) goto fail;
    }
    order_by = PyList_New(0);
    if (!order_by) goto fail;
    if (accept_kw(p, "ORDER")) {
        if (!expect_kw(p, "BY")) goto fail;
        for (;;) {
            PyObject *col = dotted_ident(p);
            if (!col) goto fail;
            int desc = 0;
            if (accept_kw(p, "DESC")) desc = 1;
            else accept_kw(p, "ASC");
            PyObject *tup;
            if (accept_kw(p, "NULLS")) {
                int nf;
                if (accept_kw(p, "FIRST")) nf = 1;
                else if (accept_kw(p, "LAST")) nf = 0;
                else { p->fb = 1; Py_DECREF(col); goto fail; }
                tup = PyTuple_Pack(3, col, desc ? Py_True : Py_False,
                                   nf ? Py_True : Py_False);
            } else {
                tup = PyTuple_Pack(2, col, desc ? Py_True : Py_False);
            }
            Py_DECREF(col);
            if (!tup || PyList_Append(order_by, tup) != 0) {
                Py_XDECREF(tup);
                goto fail;
            }
            Py_DECREF(tup);
            if (!accept_punct(p, ",")) break;
        }
    }
    for (;;) {
        if (accept_kw(p, "LIMIT")) {
            int neg = accept_punct(p, "-");
            Tk *t = cur(p);
            int isint = 0;
            if (t->kind != TK_NUMBER) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *v = dec_number(p, t, &isint);
            if (!v) goto fail;
            if (!isint) { p->fb = 1; Py_DECREF(v); goto fail; }
            if (neg) {
                PyObject *nv = PyNumber_Negative(v);
                Py_DECREF(v);
                if (!nv) goto fail;
                v = nv;
            }
            Py_XDECREF(limit);
            limit = v;
        } else if (accept_kw(p, "OFFSET")) {
            int neg = accept_punct(p, "-");
            Tk *t = cur(p);
            int isint = 0;
            if (t->kind != TK_NUMBER) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *v = dec_number(p, t, &isint);
            if (!v) goto fail;
            if (!isint) { p->fb = 1; Py_DECREF(v); goto fail; }
            offset = PyLong_AsLongLong(v);
            Py_DECREF(v);
            if (neg) offset = -offset;
        } else {
            break;
        }
    }
    {
        PyObject *joins = PyList_New(0);
        PyObject *group_by = PyList_New(0);
        PyObject *off = PyLong_FromLongLong(offset);
        if (!joins || !group_by || !off) {
            Py_XDECREF(joins); Py_XDECREF(group_by); Py_XDECREF(off);
            goto fail;
        }
        PyObject *vals[10] = {
            table, items, where ? where : Py_NewRef(Py_None), joins,
            group_by, Py_NewRef(Py_None) /*having*/, order_by,
            limit ? limit : Py_NewRef(Py_None), off,
            Py_NewRef(distinct ? Py_True : Py_False)};
        return make_obj(C_SELECT, vals);
    }
fail:
    Py_DECREF(items);
    Py_DECREF(table);
    Py_XDECREF(where);
    Py_XDECREF(order_by);
    Py_XDECREF(limit);
    return NULL;
}

// ---------------------------------------------------------------------------
// INSERT INTO t [(cols)] VALUES (…), (…)…      (INSERT … SELECT -> fallback)
// Insert fields: table, columns, rows, select
// ---------------------------------------------------------------------------

static PyObject *parse_insert(P *p) {
    if (!expect_kw(p, "INTO")) return NULL;
    Tk *tt = cur(p);
    if (tt->kind != TK_IDENT) { p->fb = 1; return NULL; }
    adv(p);
    PyObject *table = tok_str(p, tt);
    if (!table) return NULL;
    PyObject *columns = NULL;
    PyObject *rows = NULL;
    if (accept_punct(p, "(")) {
        columns = PyList_New(0);
        if (!columns) goto fail;
        for (;;) {
            Tk *c = cur(p);
            if (c->kind != TK_IDENT) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *cn = tok_str(p, c);
            if (!cn || PyList_Append(columns, cn) != 0) {
                Py_XDECREF(cn);
                goto fail;
            }
            Py_DECREF(cn);
            if (!accept_punct(p, ",")) break;
        }
        if (!expect_punct(p, ")")) goto fail;
    }
    if (tk_kw(p, cur(p), "SELECT")) { p->fb = 1; goto fail; }
    if (!expect_kw(p, "VALUES")) goto fail;
    rows = PyList_New(0);
    if (!rows) goto fail;
    for (;;) {
        if (!expect_punct(p, "(")) goto fail;
        PyObject *row = PyList_New(0);
        if (!row) goto fail;
        for (;;) {
            PyObject *v = parse_value(p);
            if (!v || PyList_Append(row, v) != 0) {
                Py_XDECREF(v); Py_DECREF(row);
                goto fail;
            }
            Py_DECREF(v);
            if (!accept_punct(p, ",")) break;
        }
        if (!expect_punct(p, ")")) { Py_DECREF(row); goto fail; }
        if (PyList_Append(rows, row) != 0) { Py_DECREF(row); goto fail; }
        Py_DECREF(row);
        if (!accept_punct(p, ",")) break;
    }
    {
        PyObject *vals[4] = {table,
                             columns ? columns : Py_NewRef(Py_None), rows,
                             Py_NewRef(Py_None)};
        return make_obj(C_INSERT, vals);
    }
fail:
    Py_DECREF(table);
    Py_XDECREF(columns);
    Py_XDECREF(rows);
    return NULL;
}

// ---------------------------------------------------------------------------
// SIMILAR 'key'|[vec] [TOP n|LIMIT n] [METRIC m] [CONNECTED TO 'k']
//         [IN coll] [WHERE cond]
// Similar fields: query_key, query_vector, limit, metric, connected_to,
//                 collection, where
// ---------------------------------------------------------------------------

static const struct { const char *up; const char *val; } METRICS[] = {
    {"COSINE", "cosine"}, {"EUCLIDEAN", "euclidean"}, {"DOT", "dot"},
    {"DOT_PRODUCT", "dot"}, {"MANHATTAN", "manhattan"},
    {"COMPOSITE", "composite"}, {"GEOMETRIC", "composite"},
    {"WEIGHTED_JACCARD", "weighted_jaccard"},
    {"WJACCARD", "weighted_jaccard"},
    {"ANGULAR", "angular"}, {"GEODESIC", "geodesic"},
    {"JACCARD", "jaccard"}, {"OVERLAP", "overlap"}, {NULL, NULL}};

static PyObject *parse_similar(P *p) {
    PyObject *qkey = NULL, *qvec = NULL, *limit = NULL, *metric = NULL;
    PyObject *conn = NULL, *coll = NULL, *where = NULL;
    if (at_punct(p, "[")) {
        qvec = parse_vector(p);
        if (!qvec) return NULL;
    } else {
        Tk *t = cur(p);
        if (t->kind != TK_STRING) { p->fb = 1; return NULL; }
        adv(p);
        qkey = dec_string(p, t);
        if (!qkey) return NULL;
    }
    for (;;) {
        if (accept_kw(p, "TOP") || accept_kw(p, "LIMIT")) {
            int neg = accept_punct(p, "-");
            Tk *t = cur(p);
            int isint = 0;
            if (t->kind != TK_NUMBER) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *v = dec_number(p, t, &isint);
            if (!v) goto fail;
            if (!isint) { p->fb = 1; Py_DECREF(v); goto fail; }
            if (neg) {
                PyObject *nv = PyNumber_Negative(v);
                Py_DECREF(v);
                if (!nv) goto fail;
                v = nv;
            }
            Py_XDECREF(limit);
            limit = v;
        } else if (accept_kw(p, "METRIC")) {
            Tk *t = cur(p);
            if (t->kind != TK_IDENT) { p->fb = 1; goto fail; }
            int mi = -1;
            for (int m = 0; METRICS[m].up; m++)
                if (tk_kw(p, t, METRICS[m].up)) { mi = m; break; }
            if (mi < 0) { p->fb = 1; goto fail; }   // Python raises
            adv(p);
            Py_XDECREF(metric);
            metric = PyUnicode_FromString(METRICS[mi].val);
            if (!metric) goto fail;
        } else if (accept_kw(p, "CONNECTED")) {
            if (!expect_kw(p, "TO")) goto fail;
            Tk *t = cur(p);
            if (t->kind != TK_STRING) { p->fb = 1; goto fail; }
            adv(p);
            Py_XDECREF(conn);
            conn = dec_string(p, t);
            if (!conn) goto fail;
        } else if (accept_kw(p, "IN")) {
            Tk *t = cur(p);
            if (t->kind != TK_IDENT) { p->fb = 1; goto fail; }
            adv(p);
            Py_XDECREF(coll);
            coll = tok_str(p, t);
            if (!coll) goto fail;
        } else if (accept_kw(p, "WHERE")) {
            Py_XDECREF(where);
            where = parse_or(p);
            if (!where) goto fail;
        } else {
            break;
        }
    }
    {
        PyObject *vals[7] = {
            qkey ? qkey : Py_NewRef(Py_None),
            qvec ? qvec : Py_NewRef(Py_None),
            limit ? limit : PyLong_FromLong(10),
            metric ? metric : Py_NewRef(Py_None),
            conn ? conn : Py_NewRef(Py_None),
            coll ? coll : Py_NewRef(Py_None),
            where ? where : Py_NewRef(Py_None)};
        if (!vals[2]) {
            for (int i = 0; i < 7; i++)
                if (i != 2) Py_XDECREF(vals[i]);
            return NULL;
        }
        return make_obj(C_SIMILAR, vals);
    }
fail:
    Py_XDECREF(qkey);
    Py_XDECREF(qvec);
    Py_XDECREF(limit);
    Py_XDECREF(metric);
    Py_XDECREF(conn);
    Py_XDECREF(coll);
    Py_XDECREF(where);
    return NULL;
}

// ---------------------------------------------------------------------------
// NODE CREATE label {props}        (GET/DELETE/LIST -> fallback)
// NodeCreate fields: label, properties
// ---------------------------------------------------------------------------

static PyObject *parse_property_map(P *p) {
    if (!expect_punct(p, "{")) return NULL;
    PyObject *props = PyDict_New();
    if (!props) return NULL;
    if (!at_punct(p, "}")) {
        for (;;) {
            Tk *kt = cur(p);
            if (kt->kind != TK_IDENT) { p->fb = 1; goto fail; }
            adv(p);
            if (!expect_punct(p, ":")) goto fail;
            PyObject *key = tok_str(p, kt);
            if (!key) goto fail;
            PyObject *v = parse_value(p);
            if (!v) { Py_DECREF(key); goto fail; }
            int rc = PyDict_SetItem(props, key, v);
            Py_DECREF(key);
            Py_DECREF(v);
            if (rc != 0) goto fail;
            if (!accept_punct(p, ",")) break;
        }
    }
    if (!expect_punct(p, "}")) goto fail;
    return props;
fail:
    Py_DECREF(props);
    return NULL;
}

static PyObject *parse_node(P *p) {
    if (!accept_kw(p, "CREATE")) { p->fb = 1; return NULL; }
    Tk *lt = cur(p);
    if (lt->kind != TK_IDENT) { p->fb = 1; return NULL; }
    adv(p);
    PyObject *label = tok_str(p, lt);
    if (!label) return NULL;
    PyObject *props;
    if (at_punct(p, "{")) {
        props = parse_property_map(p);
        if (!props) { Py_DECREF(label); return NULL; }
    } else {
        props = PyDict_New();
        if (!props) { Py_DECREF(label); return NULL; }
    }
    PyObject *vals[2] = {label, props};
    return make_obj(C_NODECREATE, vals);
}

// ---------------------------------------------------------------------------
// FIND NODE|EDGE|ROWS|ENTITY [label] [WHERE cond] [SIMILAR TO …]
//      [CONNECTED TO 'k'] [LIMIT n]          (FIND PATH -> fallback)
// Find fields: target, label, where, similar_to, connected_to, limit,
//              return_items, path_from, path_edge, path_to
// (VERTEX / bare FIND / RETURN are reference-grammar forms handled by
// the Python fallback: the keyword check below or the trailing-input
// check rejects them here)
// ---------------------------------------------------------------------------

static PyObject *parse_find(P *p) {
    const char *target = NULL;
    if (accept_kw(p, "NODE")) target = "node";
    else if (accept_kw(p, "EDGE")) target = "edge";
    else if (accept_kw(p, "ROWS")) target = "rows";
    else if (accept_kw(p, "ENTITY")) target = "entity";
    else { p->fb = 1; return NULL; }          // PATH and errors: Python
    PyObject *label = NULL, *where = NULL, *sim = NULL, *conn = NULL;
    PyObject *limit = NULL;
    if (strcmp(target, "rows") == 0) {
        if (!expect_kw(p, "FROM")) return NULL;
        Tk *t = cur(p);
        if (t->kind != TK_IDENT) { p->fb = 1; return NULL; }
        adv(p);
        label = tok_str(p, t);
        if (!label) return NULL;
    } else {
        Tk *t = cur(p);
        if (t->kind == TK_STRING) { p->fb = 1; return NULL; }  // Python raises
        if (t->kind == TK_IDENT && !tk_kw(p, t, "WHERE") &&
            !tk_kw(p, t, "SIMILAR") && !tk_kw(p, t, "CONNECTED") &&
            !tk_kw(p, t, "LIMIT")) {
            adv(p);
            label = tok_str(p, t);
            if (!label) return NULL;
        }
    }
    for (;;) {
        if (accept_kw(p, "WHERE")) {
            Py_XDECREF(where);
            where = parse_or(p);
            if (!where) goto fail;
        } else if (accept_kw(p, "SIMILAR")) {
            if (!expect_kw(p, "TO")) goto fail;
            Py_XDECREF(sim);
            if (at_punct(p, "[")) {
                sim = parse_vector(p);
            } else {
                Tk *t = cur(p);
                if (t->kind != TK_STRING) { p->fb = 1; goto fail; }
                adv(p);
                sim = dec_string(p, t);
            }
            if (!sim) goto fail;
        } else if (accept_kw(p, "CONNECTED")) {
            if (!expect_kw(p, "TO")) goto fail;
            Tk *t = cur(p);
            if (t->kind != TK_STRING) { p->fb = 1; goto fail; }
            adv(p);
            Py_XDECREF(conn);
            conn = dec_string(p, t);
            if (!conn) goto fail;
        } else if (accept_kw(p, "LIMIT")) {
            int neg = accept_punct(p, "-");
            Tk *t = cur(p);
            int isint = 0;
            if (t->kind != TK_NUMBER) { p->fb = 1; goto fail; }
            adv(p);
            PyObject *v = dec_number(p, t, &isint);
            if (!v) goto fail;
            if (!isint) { p->fb = 1; Py_DECREF(v); goto fail; }
            if (neg) {
                PyObject *nv = PyNumber_Negative(v);
                Py_DECREF(v);
                if (!nv) goto fail;
                v = nv;
            }
            Py_XDECREF(limit);
            limit = v;
        } else {
            break;
        }
    }
    {
        PyObject *tgt = PyUnicode_FromString(target);
        if (!tgt) goto fail;
        PyObject *vals[10] = {
            tgt, label ? label : Py_NewRef(Py_None),
            where ? where : Py_NewRef(Py_None),
            sim ? sim : Py_NewRef(Py_None),
            conn ? conn : Py_NewRef(Py_None),
            limit ? limit : Py_NewRef(Py_None),
            Py_NewRef(Py_None), Py_NewRef(Py_None), Py_NewRef(Py_None),
            Py_NewRef(Py_None)};
        return make_obj(C_FIND, vals);
    }
fail:
    Py_XDECREF(label);
    Py_XDECREF(where);
    Py_XDECREF(sim);
    Py_XDECREF(conn);
    Py_XDECREF(limit);
    return NULL;
}

// ---------------------------------------------------------------------------
// UPDATE t SET col = lit [, ...] [WHERE cond]   (expression RHS -> fallback)
// Update fields: table, updates, where
// ---------------------------------------------------------------------------

static PyObject *parse_update(P *p) {
    Tk *tt = cur(p);
    if (tt->kind != TK_IDENT) { p->fb = 1; return NULL; }
    adv(p);
    PyObject *table = tok_str(p, tt);
    if (!table) return NULL;
    if (!expect_kw(p, "SET")) { Py_DECREF(table); return NULL; }
    PyObject *updates = PyDict_New();
    PyObject *where = NULL;
    if (!updates) { Py_DECREF(table); return NULL; }
    for (;;) {
        Tk *ct = cur(p);
        if (ct->kind != TK_IDENT) { p->fb = 1; goto fail; }
        adv(p);
        if (!expect_punct(p, "=")) goto fail;
        // expression RHS: '(' or value followed by an arith op
        Tk *v1 = cur(p), *v2 = peek1(p);
        if (v1->kind == TK_PUNCT && tk_text_is(p, v1, "(")) {
            p->fb = 1;
            goto fail;
        }
        if ((v1->kind == TK_NUMBER || v1->kind == TK_IDENT) &&
            v2->kind == TK_PUNCT && v2->len == 1 &&
            strchr("+-*/%", p->src[v2->start]) != NULL) {
            p->fb = 1;
            goto fail;
        }
        {
            PyObject *col = tok_str(p, ct);
            if (!col) goto fail;
            PyObject *v = parse_value(p);
            if (!v) { Py_DECREF(col); goto fail; }
            int rc = PyDict_SetItem(updates, col, v);
            Py_DECREF(col);
            Py_DECREF(v);
            if (rc != 0) goto fail;
        }
        if (!accept_punct(p, ",")) break;
    }
    if (accept_kw(p, "WHERE")) {
        where = parse_or(p);
        if (!where) goto fail;
    }
    {
        PyObject *vals[3] = {table, updates,
                             where ? where : Py_NewRef(Py_None)};
        return make_obj(C_UPDATE, vals);
    }
fail:
    Py_DECREF(table);
    Py_DECREF(updates);
    Py_XDECREF(where);
    return NULL;
}

// DELETE FROM t [WHERE cond]   — Delete fields: table, where
static PyObject *parse_delete(P *p) {
    if (!expect_kw(p, "FROM")) return NULL;
    Tk *tt = cur(p);
    if (tt->kind != TK_IDENT) { p->fb = 1; return NULL; }
    adv(p);
    PyObject *table = tok_str(p, tt);
    if (!table) return NULL;
    PyObject *where = NULL;
    if (accept_kw(p, "WHERE")) {
        where = parse_or(p);
        if (!where) { Py_DECREF(table); return NULL; }
    }
    PyObject *vals[2] = {table, where ? where : Py_NewRef(Py_None)};
    return make_obj(C_DELETE, vals);
}

// ---------------------------------------------------------------------------
// EMBED ['key' [vec]] | STORE/GET/DELETE forms   (BATCH/BUILD -> fallback)
// EmbedStore fields: key, vector, collection
// EmbedGet/EmbedDelete fields: key, collection
// ---------------------------------------------------------------------------

static PyObject *parse_embed(P *p) {
    int ci = C_EMBEDSTORE;
    int has_vec = 1;
    if (accept_kw(p, "STORE")) {
        ci = C_EMBEDSTORE;
    } else if (accept_kw(p, "GET")) {
        ci = C_EMBEDGET;
        has_vec = 0;
    } else if (accept_kw(p, "DELETE")) {
        ci = C_EMBEDDELETE;
        has_vec = 0;
    } else if (tk_kw(p, cur(p), "BATCH") || tk_kw(p, cur(p), "BUILD")) {
        p->fb = 1;
        return NULL;
    }
    Tk *kt = cur(p);
    if (kt->kind != TK_STRING) { p->fb = 1; return NULL; }
    adv(p);
    PyObject *key = dec_string(p, kt);
    if (!key) return NULL;
    PyObject *vec = NULL;
    if (has_vec) {
        vec = parse_vector(p);
        if (!vec) { Py_DECREF(key); return NULL; }
    }
    PyObject *coll = NULL;
    if (accept_kw(p, "IN")) {
        Tk *c = cur(p);
        if (c->kind != TK_IDENT) {
            p->fb = 1;
            Py_DECREF(key);
            Py_XDECREF(vec);
            return NULL;
        }
        adv(p);
        coll = tok_str(p, c);
        if (!coll) { Py_DECREF(key); Py_XDECREF(vec); return NULL; }
    }
    if (has_vec) {
        PyObject *vals[3] = {key, vec,
                             coll ? coll : Py_NewRef(Py_None)};
        return make_obj(C_EMBEDSTORE, vals);
    }
    PyObject *vals[2] = {key, coll ? coll : Py_NewRef(Py_None)};
    return make_obj(ci, vals);
}

// ---------------------------------------------------------------------------
// entry: parse(src) -> Statement | None (fallback)
// ---------------------------------------------------------------------------

static PyObject *py_parse(PyObject *self, PyObject *arg) {
    if (!g_ready || !PyUnicode_Check(arg)) Py_RETURN_NONE;
    P p;
    Py_ssize_t n;
    const char *src = PyUnicode_AsUTF8AndSize(arg, &n);
    if (!src) return NULL;
    if (n > INT32_MAX) Py_RETURN_NONE;
    p.src = src;
    p.n = n;
    if (lex_all(&p) != 0) Py_RETURN_NONE;
    PyObject *stmt = NULL;
    Tk *t0 = cur(&p);
    if (tk_kw(&p, t0, "SELECT")) {
        adv(&p);
        stmt = parse_select(&p);
    } else if (tk_kw(&p, t0, "INSERT")) {
        adv(&p);
        stmt = parse_insert(&p);
    } else if (tk_kw(&p, t0, "SIMILAR")) {
        adv(&p);
        stmt = parse_similar(&p);
    } else if (tk_kw(&p, t0, "NODE")) {
        adv(&p);
        stmt = parse_node(&p);
    } else if (tk_kw(&p, t0, "FIND")) {
        adv(&p);
        stmt = parse_find(&p);
    } else if (tk_kw(&p, t0, "UPDATE")) {
        adv(&p);
        stmt = parse_update(&p);
    } else if (tk_kw(&p, t0, "DELETE")) {
        adv(&p);
        stmt = parse_delete(&p);
    } else if (tk_kw(&p, t0, "EMBED")) {
        adv(&p);
        stmt = parse_embed(&p);
    } else {
        Py_RETURN_NONE;
    }
    if (!stmt) {
        if (PyErr_Occurred()) return NULL;   // real error (MemoryError…)
        Py_RETURN_NONE;                      // fallback
    }
    while (accept_punct(&p, ";")) {}
    if (cur(&p)->kind != TK_EOF) {            // trailing input: Python raises
        Py_DECREF(stmt);
        Py_RETURN_NONE;
    }
    return stmt;
}

// parse_full(src) -> Statement. Fast path when covered; otherwise the
// registered Python fallback parser runs (and raises its own errors).
// Bound as lang.parser.parse so the hot path has zero Python frames.
static PyObject *py_parse_full(PyObject *self, PyObject *arg) {
    PyObject *r = py_parse(self, arg);
    if (!r || r != Py_None)
        return r;
    Py_DECREF(r);
    if (!g_fallback) {
        PyErr_SetString(PyExc_RuntimeError,
                        "parser fallback not registered");
        return NULL;
    }
    return PyObject_CallOneArg(g_fallback, arg);
}

static PyObject *py_set_fallback(PyObject *self, PyObject *arg) {
    if (arg == Py_None) {
        Py_CLEAR(g_fallback);
        Py_RETURN_NONE;
    }
    if (!PyCallable_Check(arg)) {
        PyErr_SetString(PyExc_TypeError, "fallback must be callable");
        return NULL;
    }
    Py_XSETREF(g_fallback, Py_NewRef(arg));
    Py_RETURN_NONE;
}

// init_parser(specs): specs = ((name, cls, (field, …)), …)
static PyObject *py_init_parser(PyObject *self, PyObject *arg) {
    static const char *want[C_N] = {"Select", "SelectItem", "Insert",
                                    "Similar", "Condition", "NodeCreate",
                                    "Find", "Update", "Delete",
                                    "EmbedStore", "EmbedGet",
                                    "EmbedDelete"};
    g_ready = 0;
    PyObject *seq = PySequence_Fast(arg, "specs not a sequence");
    if (!seq) return NULL;
    int seen[C_N] = {0};
    for (Py_ssize_t i = 0; i < PySequence_Fast_GET_SIZE(seq); i++) {
        PyObject *spec = PySequence_Fast_GET_ITEM(seq, i);
        const char *name;
        PyObject *cls, *fields;
        if (!PyArg_ParseTuple(spec, "sOO", &name, &cls, &fields)) {
            Py_DECREF(seq);
            return NULL;
        }
        int ci = -1;
        for (int c = 0; c < C_N; c++)
            if (strcmp(name, want[c]) == 0) { ci = c; break; }
        if (ci < 0) continue;
        PyObject *fs = PySequence_Fast(fields, "fields not a sequence");
        if (!fs) { Py_DECREF(seq); return NULL; }
        Py_ssize_t nf = PySequence_Fast_GET_SIZE(fs);
        if (nf > MAX_FIELDS || nf != g_want_nf[ci]) {
            Py_DECREF(fs);
            continue;       // layout drifted: stay unready, fall back
        }
        int ok = 1;
        for (Py_ssize_t f = 0; f < nf; f++) {
            PyObject *descr = PyObject_GetAttr(
                cls, PySequence_Fast_GET_ITEM(fs, f));
            if (!descr || Py_TYPE(descr) != &PyMemberDescr_Type) {
                Py_XDECREF(descr);
                PyErr_Clear();
                ok = 0;
                break;
            }
            g_off[ci][f] = ((PyMemberDescrObject *)descr)->d_member->offset;
            Py_DECREF(descr);
        }
        Py_DECREF(fs);
        if (!ok) continue;
        g_nf[ci] = (int)nf;
        Py_XSETREF(g_cls[ci], Py_NewRef(cls));
        seen[ci] = 1;
    }
    Py_DECREF(seq);
    int all = 1;
    for (int c = 0; c < C_N; c++)
        if (!seen[c]) all = 0;
    g_ready = all;
    return PyBool_FromLong(all);
}

static PyMethodDef methods[] = {
    {"init_parser", py_init_parser, METH_O,
     "init_parser(((name, cls, (fields…)), …)) -> bool"},
    {"parse", py_parse, METH_O,
     "parse(src) -> Statement | None (None = use the Python parser)"},
    {"parse_full", py_parse_full, METH_O,
     "parse_full(src) -> Statement (falls back to the registered "
     "Python parser for uncovered grammar)"},
    {"set_fallback", py_set_fallback, METH_O,
     "set_fallback(callable | None) registers the Python parser "
     "parse_full delegates uncovered statements to"},
    {NULL, NULL, 0, NULL},
};

static struct PyModuleDef moddef = {
    PyModuleDef_HEAD_INIT, "_neumann_parser",
    "Native fast-path parser for hot statement shapes.", -1, methods,
};

extern "C" PyMODINIT_FUNC PyInit__neumann_parser(void) {
    s_star = PyUnicode_InternFromString("*");
    s_ops[OP_EQ] = PyUnicode_InternFromString("=");
    s_ops[OP_NE] = PyUnicode_InternFromString("!=");
    s_ops[OP_LT] = PyUnicode_InternFromString("<");
    s_ops[OP_LE] = PyUnicode_InternFromString("<=");
    s_ops[OP_GT] = PyUnicode_InternFromString(">");
    s_ops[OP_GE] = PyUnicode_InternFromString(">=");
    s_ops[OP_AND] = PyUnicode_InternFromString("and");
    s_ops[OP_OR] = PyUnicode_InternFromString("or");
    s_ops[OP_NOT] = PyUnicode_InternFromString("not");
    s_ops[OP_IN] = PyUnicode_InternFromString("in");
    s_ops[OP_LIKE] = PyUnicode_InternFromString("like");
    s_ops[OP_ISNULL] = PyUnicode_InternFromString("is_null");
    s_ops[OP_ISNOTNULL] = PyUnicode_InternFromString("is_not_null");
    return PyModule_Create(&moddef);
}
