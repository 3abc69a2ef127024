// METIS reader: the body of a vertex-weighted METIS file (every line after
// the header ``N E 10``) straight to the canonical symmetric CSR, in two
// O(file + m) passes and with no global sort.
//
// Line u (0-based) holds u's weight, then its 1-indexed neighbours.  As in
// the reference's parser, only neighbours v > u are kept, each row's kept
// list sorted and deduplicated, so self-loops and one-sided entries drop
// out.  A token is an optionally signed run of ASCII digits; ' ', '\t',
// '\r' and '\n' separate tokens, '\n' ends a line.  Lines after the n-th
// are only checked to hold integers.
//
// Pass 1 (metis_upper) keeps the upper entries row by row.  A METIS file
// written from a sorted CSR lists each row in ascending order, so its kept
// entries arrive in canonical (u, v) order; a row that does not is sorted
// and deduplicated in place, and counted.  Pass 2 (metis_csr) counts the
// degrees and writes every row as its lower neighbours, in the order their
// rows come (ascending), then its upper ones, so every row comes out
// sorted without a sort.
#pragma once

#include <algorithm>
#include <cstdint>
#include <vector>

namespace mwvc {

enum MetisStatus : int {
    METIS_OK = 0,
    METIS_NO_WEIGHT = 1,    // a vertex line without a token (or missing)
    METIS_NOT_INTEGER = 2,  // a token that is no int64
    METIS_OUT_OF_RANGE = 3  // a neighbour beyond the n vertices
};

inline bool metis_sep(char c) {
    return c == ' ' || c == '\t' || c == '\r' || c == '\n';
}

// The token that starts at p (not a separator) into *out; p moves past it.
// False if it is not an optionally signed run of digits ending at a
// separator or at the end, or does not fit an int64.
inline bool metis_token(const char *&p, const char *end, int64_t *out) {
    bool neg = false;
    if (*p == '+' || *p == '-') {
        neg = *p == '-';
        ++p;
    }
    const char *first = p;
    uint64_t v = 0;
    for (; p < end && (unsigned char)(*p - '0') < 10; ++p) {
        uint64_t d = (uint64_t)(*p - '0');
        if (v > (UINT64_MAX - d) / 10)
            return false;
        v = v * 10 + d;
    }
    if (p == first || (p < end && !metis_sep(*p)))
        return false;
    if (v > (neg ? (uint64_t)INT64_MAX + 1 : (uint64_t)INT64_MAX))
        return false;
    *out = neg ? (int64_t)(0 - v) : (int64_t)v;
    return true;
}

// Pass 1.  weights[u] and up_count[u] for the n vertex lines; the kept
// neighbours of every row, rows in order, into upper (room for one entry
// per token: (len + 1) / 2).  out3 = {entries kept, rows sorted or
// deduplicated, 1-based line of the error}.  Returns a MetisStatus.
inline int metis_upper(const char *s, uint64_t len, uint64_t n,
                       int64_t *weights, uint64_t *up_count, int64_t *upper,
                       uint64_t *out3) {
    const char *p = s, *end = s + len;
    uint64_t k = 0, rows_sorted = 0;
    out3[2] = 0;
    for (uint64_t u = 0; u < n; ++u) {
        uint64_t row = k;
        bool weighted = false, ascending = true;
        for (;;) {
            while (p < end && *p != '\n' && metis_sep(*p))
                ++p;
            if (p == end || *p == '\n')
                break;
            int64_t t;
            if (!metis_token(p, end, &t)) {
                out3[2] = u + 1;
                return METIS_NOT_INTEGER;
            }
            if (!weighted) {
                weights[u] = t;
                weighted = true;
            } else if (t > (int64_t)u + 1) {  // v = t - 1 > u
                if ((uint64_t)t > n) {
                    out3[2] = u + 1;
                    return METIS_OUT_OF_RANGE;
                }
                if (k > row && t - 1 <= upper[k - 1])
                    ascending = false;
                upper[k++] = t - 1;
            }
        }
        if (!weighted) {
            out3[2] = u + 1;
            return METIS_NO_WEIGHT;
        }
        if (!ascending) {
            std::sort(upper + row, upper + k);
            k = (uint64_t)(std::unique(upper + row, upper + k) - upper);
            ++rows_sorted;
        }
        up_count[u] = k - row;
        if (p < end)
            ++p;  // the '\n'
    }
    for (uint64_t line = n; p < end;) {
        if (*p == '\n') {
            ++line;
            ++p;
        } else if (metis_sep(*p)) {
            ++p;
        } else {
            int64_t t;
            if (!metis_token(p, end, &t)) {
                out3[2] = line + 1;
                return METIS_NOT_INTEGER;
            }
        }
    }
    out3[0] = k;
    out3[1] = rows_sorted;
    return METIS_OK;
}

// Pass 2.  The symmetric CSR of pass 1's rows: indptr (n + 1), indices
// (2 x entries kept).
inline void metis_csr(uint64_t n, const uint64_t *up_count,
                      const int64_t *upper, uint64_t kept, int64_t *indptr,
                      int64_t *indices) {
    indptr[0] = 0;
    for (uint64_t u = 0; u < n; ++u)
        indptr[u + 1] = (int64_t)up_count[u];
    for (uint64_t e = 0; e < kept; ++e)
        ++indptr[upper[e] + 1];
    for (uint64_t u = 0; u < n; ++u)
        indptr[u + 1] += indptr[u];
    // next[x]: where row x's next lower neighbour goes; when the walk
    // reaches row u, every row below it has written its entry into u's
    // row, so next[u] is where u's upper neighbours start
    std::vector<int64_t> next(indptr, indptr + n);
    uint64_t e = 0;
    for (uint64_t u = 0; u < n; ++u) {
        int64_t *mine = indices + next[u];
        for (uint64_t j = 0; j < up_count[u]; ++j, ++e) {
            int64_t v = upper[e];
            mine[j] = v;
            indices[next[v]++] = (int64_t)u;
        }
    }
}

}  // namespace mwvc
