// fastcsv: native CSV tokenizer for the parse hot path.
//
// Reference: the parse fast path in water/parser/CsvParser.java — a
// byte-level tokenizer over raw chunks that never materializes Java
// Strings for numeric cells — and the distributed layout of
// MultiFileParseTask (ParseDataset.java:688): raw byte ranges parsed
// independently.  This is the native analog for the TPU framework's
// coordinator: one pass over the buffer, quote-aware, writing numeric
// cells straight into a preallocated double column-major matrix and
// flagging cells that need host-side (string/categorical) handling.
// `fastcsv_parse_range` takes (start, row_base) so newline-aligned byte
// ranges tokenize in parallel threads; range boundaries inside quoted
// fields are rejected host-side by quote-parity (`fastcsv_count_quotes`).
//
// Row tokenization is a fused fast path: the numeric scan IS the
// delimiter scan for plain-number cells, and simple quoted cells
// ("payload" followed by a delimiter — the pyarrow/excel writer shape)
// jump straight to their closing quote via memchr.  Any hairy row
// (escaped "" quotes, mid-cell quotes, quoted newlines) restarts under
// the exact quote-state machine, so the fast path never changes results.
//
// Number parsing: a hand-rolled digits/exponent scanner (~20 ns/cell)
// for the forms that dominate real CSVs; anything else (inf, nan, hex
// floats, >18 significant digits) falls back to strtod for exactness.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>

namespace {

const double kPow10[] = {
    1e0, 1e1, 1e2, 1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10, 1e11, 1e12,
    1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

// Scan a plain decimal/scientific number starting at s.  Returns the first
// unconsumed position, or nullptr when the prefix is not a plain number
// (caller falls back to the delimiter scan / strtod / text flag).
inline const char* scan_num(const char* s, const char* e, double* out) {
    const char* p = s;
    bool neg = false;
    if (p < e && (*p == '+' || *p == '-')) { neg = *p == '-'; ++p; }
    uint64_t mant = 0;
    int digits = 0, frac = 0;
    bool any = false;
    while (p < e && *p >= '0' && *p <= '9') {
        if (digits >= 18) return nullptr;        // too long: strtod path
        mant = mant * 10 + (*p - '0'); ++digits;
        any = true; ++p;
    }
    if (p < e && *p == '.') {
        ++p;
        while (p < e && *p >= '0' && *p <= '9') {
            if (digits >= 18) return nullptr;
            mant = mant * 10 + (*p - '0'); ++digits; ++frac;
            any = true; ++p;
        }
    }
    if (!any) return nullptr;
    int exp10 = -frac;
    if (p < e && (*p == 'e' || *p == 'E')) {
        ++p;
        bool eneg = false;
        if (p < e && (*p == '+' || *p == '-')) { eneg = *p == '-'; ++p; }
        const char* d0 = p;
        int ev = 0;
        while (p < e && *p >= '0' && *p <= '9') {
            ev = ev * 10 + (*p - '0');
            if (ev > 400) return nullptr;
            ++p;
        }
        if (p == d0) return nullptr;
        exp10 += eneg ? -ev : ev;
    }
    double v = (double)mant;
    // one multiply/divide by an exact power of ten keeps the result
    // correctly rounded for |exp10| <= 22 and mant < 2^53 (Clinger)
    if (exp10 > 0) {
        if (exp10 > 22) return nullptr;
        v *= kPow10[exp10];
    } else if (exp10 < 0) {
        if (exp10 < -22) return nullptr;
        v /= kPow10[-exp10];
    }
    *out = neg ? -v : v;
    return p;
}

// Parse [s, e) as a double: the whole cell must be one plain number.
inline bool parse_num(const char* s, const char* e, double* out) {
    const char* p = scan_num(s, e, out);
    return p == e && s != e;
}

// Store one tokenized cell (trims already applied; [s, e) is the
// payload, idx the column-major slot).
inline void store_cell(const char* buf, long long s, long long e,
                       long long idx, double* values, uint8_t* flags,
                       int32_t* offsets) {
    offsets[2 * idx] = (int32_t)s;
    offsets[2 * idx + 1] = (int32_t)e;
    if (s == e) {                          // empty -> NA
        values[idx] = NAN;
        flags[idx] = 0;
        return;
    }
    double v;
    if (parse_num(buf + s, buf + e, &v)) {
        values[idx] = v;
        flags[idx] = 0;
        return;
    }
    // exotic forms (inf/nan/hex/long mantissas): strtod on a copy
    char tmp[64];
    long long m = e - s;
    char* endp = nullptr;
    if (m < 63) {
        memcpy(tmp, buf + s, m);
        tmp[m] = 0;
        double sv = strtod(tmp, &endp);
        if (endp == tmp + m) {
            values[idx] = sv;
            flags[idx] = 0;
            return;
        }
    }
    values[idx] = NAN;
    flags[idx] = 1;                        // text cell
}

}  // namespace

extern "C" {

// Tokenize rows of buf[start, end) with `ncols` columns, writing row
// row_base onward.  values/flags are column-major with stride max_rows;
// offsets hold absolute (into buf) byte ranges per cell.  Returns rows
// parsed; *consumed = absolute end position (on a row boundary).
long long fastcsv_parse_range(const char* buf, long long start,
                              long long end, char sep, int ncols,
                              long long max_rows, long long row_base,
                              long long row_cap,
                              double* values, uint8_t* flags,
                              int32_t* offsets, long long* consumed) {
    long long row = row_base;
    long long i = start;
    const long long len = end;
    while (row < row_cap && i < len) {
        long long line_start = i;
        int col = 0;
        bool saw_any = false;
        bool complete = false;

        // ---- fused fast row: numeric scan doubles as delimiter scan;
        //      simple quoted cells jump to their closing quote
        for (;;) {
            long long cell_start = i;
            while (i < len && (buf[i] == ' ' || buf[i] == '\t')) ++i;
            long long s = i;
            long long e = -1;
            double v = 0.0;
            bool numeric = false;
            if (i < len && buf[i] == '"') {
                long long qs = i + 1;
                const void* qp = memchr(buf + qs, '"', (size_t)(len - qs));
                if (qp == nullptr) goto careful_row;     // mid-quote EOF
                long long q = (const char*)qp - buf;
                if (q + 1 < len && buf[q + 1] == '"') goto careful_row;
                long long t = q + 1;
                while (t < len && (buf[t] == ' ' || buf[t] == '\t')) ++t;
                char c2 = (t < len) ? buf[t] : '\n';
                if (c2 != sep && c2 != '\n' && c2 != '\r')
                    goto careful_row;                    // "x"y junk cell
                s = qs;
                e = q;
                i = t;
            } else {
                const char* np = scan_num(buf + i, buf + len, &v);
                if (np != nullptr && np != buf + i) {
                    long long q = np - buf;
                    long long t = q;
                    while (t < len && (buf[t] == ' ' || buf[t] == '\t'))
                        ++t;
                    char c2 = (t < len) ? buf[t] : '\n';
                    if (c2 == sep || c2 == '\n' || c2 == '\r') {
                        numeric = true;
                        e = q;
                        i = t;
                    }
                }
                if (!numeric) {
                    long long t = i;
                    while (t < len && buf[t] != sep && buf[t] != '\n'
                           && buf[t] != '\r') {
                        if (buf[t] == '"') goto careful_row;  // mid-cell "
                        ++t;
                    }
                    e = t;
                    while (e > s && (buf[e - 1] == ' '
                                     || buf[e - 1] == '\t')) --e;
                    i = t;
                }
            }
            if (col < ncols) {
                long long idx = (long long)col * max_rows + row;
                if (numeric) {
                    offsets[2 * idx] = (int32_t)s;
                    offsets[2 * idx + 1] = (int32_t)e;
                    values[idx] = v;
                    flags[idx] = 0;
                } else {
                    store_cell(buf, s, e, idx, values, flags, offsets);
                }
            }
            if (i > cell_start) saw_any = true;
            ++col;
            {
                char c = (i < len) ? buf[i] : '\n';
                if (i < len && c == sep) { ++i; continue; }
                if (i < len) {
                    if (c == '\r' && i + 1 < len && buf[i + 1] == '\n') ++i;
                    ++i;
                }
                complete = true;
            }
            break;
        }
        goto row_done;

careful_row:
        // ---- exact quote-state machine (escaped quotes, quoted
        //      newlines, junk cells); restarts the whole row
        i = line_start;
        col = 0;
        saw_any = false;
        complete = false;
        {
            bool in_quotes = false;
            long long cell_start = i;
            while (i <= len) {
                char c = (i < len) ? buf[i] : '\n';
                if (in_quotes) {
                    if (c == '"') {
                        if (i + 1 < len && buf[i + 1] == '"') {
                            i += 2;
                            continue;
                        }
                        in_quotes = false;
                    }
                    ++i;
                    continue;
                }
                if (c == '"') {
                    in_quotes = true;
                    saw_any = true;
                    ++i;
                    continue;
                }
                if (c == sep || c == '\n' || c == '\r') {
                    if (col < ncols) {
                        long long s = cell_start, e = i;
                        while (s < e && (buf[s] == ' ' || buf[s] == '\t'))
                            ++s;
                        while (e > s && (buf[e - 1] == ' '
                                         || buf[e - 1] == '\t')) --e;
                        if (e - s >= 2 && buf[s] == '"'
                            && buf[e - 1] == '"') {
                            ++s; --e;
                        }
                        store_cell(buf, s, e,
                                   (long long)col * max_rows + row,
                                   values, flags, offsets);
                    }
                    ++col;
                    if (c == sep) { ++i; cell_start = i; continue; }
                    if (i < len) {
                        if (c == '\r' && i + 1 < len && buf[i + 1] == '\n')
                            ++i;
                        ++i;
                    } else {
                        i = len;
                    }
                    complete = true;
                    break;
                }
                saw_any = true;
                ++i;
            }
        }

row_done:
        if (!complete || col > ncols) {   // mid-quote EOF or over-wide row
            i = line_start;
            break;
        }
        if (!saw_any && col <= 1) continue;             // blank line
        for (int c2 = col; c2 < ncols; ++c2) {
            long long idx = (long long)c2 * max_rows + row;
            values[idx] = NAN;
            flags[idx] = 0;
            offsets[2 * idx] = offsets[2 * idx + 1] = 0;
        }
        ++row;
    }
    *consumed = (i > len) ? len : i;
    return row - row_base;
}

// Single-range compatibility entry (the original ABI).
long long fastcsv_parse(const char* buf, long long len, char sep,
                        int ncols, long long max_rows,
                        double* values, uint8_t* flags,
                        int32_t* offsets, long long* consumed) {
    return fastcsv_parse_range(buf, 0, len, sep, ncols, max_rows, 0,
                               max_rows, values, flags, offsets, consumed);
}

// Count columns of the first line (quote-aware) — ParseSetup's guess.
int fastcsv_ncols(const char* buf, long long len, char sep) {
    int cols = 1;
    bool in_quotes = false;
    for (long long i = 0; i < len; ++i) {
        char c = buf[i];
        if (in_quotes) {
            if (c == '"') in_quotes = false;
            continue;
        }
        if (c == '"') in_quotes = true;
        else if (c == sep) ++cols;
        else if (c == '\n' || c == '\r') break;
    }
    return cols;
}

// Next newline at/after `start` (before `end`), or -1 — range alignment
// for the parallel fan-out without materializing bytes from an mmap.
long long fastcsv_find_newline(const char* buf, long long start,
                               long long end) {
    if (end <= start) return -1;
    const void* p = memchr(buf + start, '\n', (size_t)(end - start));
    return p ? (long long)((const char*)p - buf) : -1;
}

// Quote count in [start, end) at memchr rate.  A byte position whose
// cumulative quote count is ODD lies inside a quoted field (the ""
// escape toggles twice, preserving parity) — the host uses prefix
// parity to reject range cuts that would split a quoted newline.
long long fastcsv_count_quotes(const char* buf, long long start,
                               long long end) {
    long long nq = 0;
    const char* p = buf + start;
    const char* stop = buf + end;
    while (p < stop) {
        const char* q = (const char*)memchr(p, '"', (size_t)(stop - p));
        if (!q) break;
        ++nq;
        p = q + 1;
    }
    return nq;
}

// Gather n variable-length cells [starts[i], ends[i]) into a fixed-width
// row-major matrix (NUL-padded) — the host-side text pass then factorizes
// the whole column with vectorized numpy on the |S width| view instead of
// a per-cell Python loop.
void fastcsv_gather_cells(const char* buf, const int32_t* starts,
                          const int32_t* ends, long long n, int width,
                          char* out) {
    for (long long i = 0; i < n; ++i) {
        long long m = (long long)ends[i] - starts[i];
        if (m < 0) m = 0;
        if (m > width) m = width;
        char* dst = out + i * (long long)width;
        if (m > 0) memcpy(dst, buf + starts[i], (size_t)m);
        if (m < width) memset(dst + m, 0, (size_t)(width - m));
    }
}

// memchr-rate scan: newline count in [start, end) and whether any quote
// appears anywhere (quotes may hide newlines -> range cuts need the
// quote-parity check; see fastcsv_count_quotes).
long long fastcsv_count_lines(const char* buf, long long start,
                              long long end, int* has_quotes) {
    long long n = 0;
    const char* p = buf + start;
    const char* stop = buf + end;
    if (has_quotes) {
        *has_quotes = memchr(p, '"', (size_t)(stop - p)) != nullptr;
    }
    while (p < stop) {
        const char* q = (const char*)memchr(p, '\n', (size_t)(stop - p));
        if (!q) break;
        ++n;
        p = q + 1;
    }
    return n;
}

}  // extern "C"
