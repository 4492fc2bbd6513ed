// (C) 2026. Licensed under the Apache License, Version 2.0.
//
// Native host kernels for sqd_tpu.
//
// The accelerator owns the compute path (JAX/XLA); these C++ routines own the
// host-side bookkeeping that feeds it — the role PySCF's C extensions play
// for the reference (SURVEY.md N1/N8).  Bitstrings are packed little-endian
// uint32 words (word 0 = orbitals 0..31), matching sqd_tpu.ops.bitpack.
//
// Build: g++ -O3 -march=native -shared -fPIC sqdcore.cpp -o libsqdcore.so

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Per-row popcount of an (n, w) packed matrix.
void popcount_rows(const uint32_t* strs, int64_t n, int w, int64_t* out) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t acc = 0;
        for (int j = 0; j < w; ++j) acc += __builtin_popcount(strs[i * w + j]);
        out[i] = acc;
    }
}

// Enumerate all two-hole intermediates K = I - u - v over every string I and
// every occupied pair (u < v).  Writes n * C(nelec, 2) rows of w words into
// `out` (caller-allocated).  Returns the number of rows written.
int64_t desdes_candidates(const uint32_t* strs, int64_t n, int w, int nelec,
                          uint32_t* out) {
    const int64_t pairs = (int64_t)nelec * (nelec - 1) / 2;
    std::vector<int> occ(nelec);
    int64_t row_out = 0;
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* s = strs + i * w;
        // collect occupied bit positions
        int cnt = 0;
        for (int j = 0; j < w && cnt < nelec; ++j) {
            uint32_t word = s[j];
            while (word && cnt < nelec) {
                int b = __builtin_ctz(word);
                occ[cnt++] = j * 32 + b;
                word &= word - 1;
            }
        }
        for (int a = 0; a < cnt; ++a) {
            for (int b = a + 1; b < cnt; ++b) {
                uint32_t* dst = out + row_out * w;
                std::memcpy(dst, s, w * sizeof(uint32_t));
                dst[occ[a] >> 5] ^= (uint32_t)1u << (occ[a] & 31);
                dst[occ[b] >> 5] ^= (uint32_t)1u << (occ[b] & 31);
                ++row_out;
            }
        }
        (void)pairs;
    }
    return row_out;
}

// Lexicographic (integer-value) sort + dedup of packed rows, in place into
// `out`.  Returns the number of unique rows.
static bool row_less(const uint32_t* a, const uint32_t* b, int w) {
    for (int j = w - 1; j >= 0; --j) {
        if (a[j] != b[j]) return a[j] < b[j];
    }
    return false;
}

int64_t sort_unique_rows(const uint32_t* rows, int64_t n, int w, uint32_t* out) {
    std::vector<int64_t> order(n);
    for (int64_t i = 0; i < n; ++i) order[i] = i;
    std::sort(order.begin(), order.end(), [&](int64_t x, int64_t y) {
        return row_less(rows + x * w, rows + y * w, w);
    });
    int64_t n_out = 0;
    for (int64_t k = 0; k < n; ++k) {
        const uint32_t* r = rows + order[k] * w;
        if (n_out == 0 || std::memcmp(out + (n_out - 1) * w, r, w * sizeof(uint32_t)) != 0) {
            std::memcpy(out + n_out * w, r, w * sizeof(uint32_t));
            ++n_out;
        }
    }
    return n_out;
}

// Pack arbitrary-width integer strings given as (n, w) little-endian uint32
// from string form is handled in Python; here we provide the fused
// "desdes + sort + unique" used by the RDM builder.
int64_t desdes_unique(const uint32_t* strs, int64_t n, int w, int nelec,
                      uint32_t* scratch, uint32_t* out) {
    int64_t total = desdes_candidates(strs, n, w, nelec, scratch);
    return sort_unique_rows(scratch, total, w, out);
}

// Membership of (strs[i] XOR xmask) in the sorted set, for packed widths
// w <= 2 via radix sort + linear merge (cache-friendly; random-access binary
// search is latency-bound both here and in device memory).  out[i] = index of the
// connected string, or -1.
void connected_membership64(const uint32_t* strs, int64_t n, const uint32_t* xmask,
                            int64_t* out) {
    const uint64_t x = (uint64_t)xmask[0] | ((uint64_t)xmask[1] << 32);
    std::vector<uint64_t> keys(n), tmp(n);
    std::vector<int64_t> order(n), order_tmp(n);
    for (int64_t i = 0; i < n; ++i) {
        uint64_t s = (uint64_t)strs[i * 2] | ((uint64_t)strs[i * 2 + 1] << 32);
        keys[i] = s ^ x;
        order[i] = i;
    }
    // LSD radix sort, 8 passes of 8 bits
    std::vector<int64_t> count(257);
    for (int pass = 0; pass < 8; ++pass) {
        int shift = pass * 8;
        std::fill(count.begin(), count.end(), 0);
        for (int64_t i = 0; i < n; ++i) ++count[((keys[i] >> shift) & 0xFF) + 1];
        for (int b = 0; b < 256; ++b) count[b + 1] += count[b];
        for (int64_t i = 0; i < n; ++i) {
            int64_t pos = count[(keys[i] >> shift) & 0xFF]++;
            tmp[pos] = keys[i];
            order_tmp[pos] = order[i];
        }
        keys.swap(tmp);
        order.swap(order_tmp);
    }
    // linear merge against the (already sorted) string set
    int64_t j = 0;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t key = keys[i];
        while (j < n) {
            uint64_t s = (uint64_t)strs[j * 2] | ((uint64_t)strs[j * 2 + 1] << 32);
            if (s < key) ++j;
            else break;
        }
        uint64_t s = j < n ? ((uint64_t)strs[j * 2] | ((uint64_t)strs[j * 2 + 1] << 32))
                           : ~(uint64_t)0;
        out[order[i]] = (j < n && s == key) ? j : -1;
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Excitation gather tables + Slater-Condon neighbor lists (host build path).
// Mirrors sqd_tpu.ops.linktab / ops.hamiltonian semantics exactly; the device
// kernels remain the reference implementation, this path just avoids XLA
// compile/executions for the one-time per-solve table builds.
// ---------------------------------------------------------------------------

static inline int popcount_below(const uint32_t* s, int w, int t) {
    // popcount of bits [0, t) of a packed row
    int full = t >> 5, rem = t & 31, acc = 0;
    for (int j = 0; j < full; ++j) acc += __builtin_popcount(s[j]);
    if (rem && full < w) acc += __builtin_popcount(s[full] & ((1u << rem) - 1u));
    return acc;
}

static inline bool get_bit(const uint32_t* s, int t) {
    return (s[t >> 5] >> (t & 31)) & 1u;
}

static inline void flip_bit(uint32_t* s, int t) { s[t >> 5] ^= 1u << (t & 31); }

static int64_t bsearch_row(const uint32_t* strs, int64_t n, int w, const uint32_t* key) {
    int64_t lo = 0, hi = n;
    while (lo < hi) {
        int64_t mid = (lo + hi) >> 1;
        if (row_less(strs + mid * w, key, w)) lo = mid + 1;
        else hi = mid;
    }
    if (lo < n && std::memcmp(strs + lo * w, key, w * sizeof(uint32_t)) == 0) return lo;
    return -1;
}

extern "C" {

// Per-(p,q) single-excitation gather tables: src[pq*n + J] = index of
// I = J - p + q (clamped to 0 with sign 0 when absent/invalid);
// sign = <J|a+_p a_q|I> parity.
void gather_tables(const uint32_t* strs, int64_t n, int w, int norb,
                   int32_t* out_src, int8_t* out_sign) {
    std::vector<uint32_t> buf(w);
    for (int p = 0; p < norb; ++p) {
        for (int q = 0; q < norb; ++q) {
            int64_t base = (int64_t)(p * norb + q) * n;
            for (int64_t j = 0; j < n; ++j) {
                const uint32_t* J = strs + j * w;
                if (p == q) {
                    bool occ = get_bit(J, p);
                    out_src[base + j] = occ ? (int32_t)j : 0;
                    out_sign[base + j] = occ ? 1 : 0;
                    continue;
                }
                if (!get_bit(J, p) || get_bit(J, q)) {
                    out_src[base + j] = 0;
                    out_sign[base + j] = 0;
                    continue;
                }
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);  // I = J - p + q
                int64_t idx = bsearch_row(strs, n, w, buf.data());
                if (idx < 0) {
                    out_src[base + j] = 0;
                    out_sign[base + j] = 0;
                    continue;
                }
                // sign on I: remove q (parity below q in I), add p (parity
                // below p in I - q == popcount_below(I, p) - [q < p])
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                out_src[base + j] = (int32_t)idx;
                out_sign[base + j] = ((s1 + s2) & 1) ? -1 : 1;
            }
        }
    }
}

// Slater-Condon same-spin neighbor candidates, laid out exactly like the
// device kernel: per row [diagonal, singles (occ x virt), doubles
// (occ-pairs x virt-pairs)]; invalid entries are (idx=0, val=0).
// eri is chemist (pq|rs), row-major norb^4; h1 is norb^2.
void samespin_candidates(const uint32_t* strs, int64_t n, int w, int norb,
                         int nelec, const double* h1, const double* eri,
                         int32_t* out_idx, double* out_val, int64_t cand_width) {
    const int nv = norb - nelec;
    const int64_t n4 = (int64_t)norb * norb * norb, n2 = (int64_t)norb * norb;
    auto E = [&](int a, int b, int c, int d) -> double {
        return eri[(int64_t)a * n4 + (int64_t)b * n2 + (int64_t)c * norb + d];
    };
    std::vector<int> occ(nelec), virt(nv);
    std::vector<uint32_t> buf(w);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        int32_t* idx_row = out_idx + i * cand_width;
        double* val_row = out_val + i * cand_width;
        // Defensive: a string whose Hamming weight disagrees with nelec would
        // overrun occ/virt (and the caller's candidate rows).  Emit an inert
        // all-zero row instead; the Python layer validates and raises first.
        int oc = 0, vc = 0;
        for (int t = 0; t < norb; ++t) {
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
            else { if (vc < nv) virt[vc] = t; ++vc; }
        }
        if (oc != nelec || vc != nv) {
            for (int64_t c0 = 0; c0 < cand_width; ++c0) { idx_row[c0] = 0; val_row[c0] = 0.0; }
            continue;
        }
        int64_t c = 0;
        // diagonal: h_pp + 1/2 sum_{p,q in J} [(pp|qq) - (pq|qp)]
        double diag = 0.0;
        for (int a = 0; a < oc; ++a) {
            int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < oc; ++b) {
                int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        idx_row[c] = (int32_t)i;
        val_row[c] = diag;
        ++c;
        // singles: I = J - p + q, val = sign * (h_pq + sum_{k in I\q} [(pq|kk)-(pk|kq)])
        for (int a = 0; a < oc; ++a) {
            for (int k = 0; k < vc; ++k, ++c) {
                int p = occ[a], q = virt[k];
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                int64_t idx = bsearch_row(strs, n, w, buf.data());
                if (idx < 0) { idx_row[c] = 0; val_row[c] = 0.0; continue; }
                double mf = h1[p * norb + q];
                for (int b = 0; b < oc; ++b) {
                    int kk = occ[b];
                    if (kk == p) continue;  // k runs over I\{q} = (J\{p}) u {q}\{q}
                    mf += E(p, q, kk, kk) - E(p, kk, kk, q);
                }
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                idx_row[c] = (int32_t)idx;
                val_row[c] = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
            }
        }
        // doubles: I = J - p - r + q + s
        for (int a = 0; a < oc; ++a) {
            for (int b = a + 1; b < oc; ++b) {
                for (int k = 0; k < vc; ++k) {
                    for (int l = k + 1; l < vc; ++l, ++c) {
                        int p = occ[a], r = occ[b], q = virt[k], s = virt[l];
                        std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                        flip_bit(buf.data(), p);
                        flip_bit(buf.data(), r);
                        flip_bit(buf.data(), q);
                        flip_bit(buf.data(), s);
                        int64_t idx = bsearch_row(strs, n, w, buf.data());
                        if (idx < 0) { idx_row[c] = 0; val_row[c] = 0.0; continue; }
                        // g = sign of a+_p a+_r a_s a_q on I (sequential)
                        int par = popcount_below(buf.data(), w, q);
                        flip_bit(buf.data(), q);
                        par += popcount_below(buf.data(), w, s);
                        flip_bit(buf.data(), s);
                        par += popcount_below(buf.data(), w, r);
                        flip_bit(buf.data(), r);
                        par += popcount_below(buf.data(), w, p);
                        double g = (par & 1) ? -1.0 : 1.0;
                        val_row[c] = 0.5 * g * (E(p, q, r, s) + E(r, s, p, q)
                                                - E(p, s, r, q) - E(r, q, p, s));
                        idx_row[c] = (int32_t)idx;
                    }
                }
            }
        }
        for (; c < cand_width; ++c) { idx_row[c] = 0; val_row[c] = 0.0; }
    }
}

// ---------------------------------------------------------------------------
// SET-INDEPENDENT "values" variants for incremental table caching.
//
// The per-string halves of the table builds (candidate excited/neighbor
// STRINGS, fermionic signs, Slater-Condon matrix elements) depend only on
// the string itself (+ integrals) — never on which other strings are in the
// set.  Emitting them lets the Python layer cache per-string rows across SQD
// iterations (where string sets overlap heavily) and redo only the cheap
// vectorized membership pass against each iteration's sorted set.
// ---------------------------------------------------------------------------

// Per-(p,q) single-excitation candidate VALUES: for each target string J and
// pair pq, the source string I = J - p + q (packed) and the parity sign, or
// sign 0 when the excitation is invalid on J.  Layout: out_val[(pq*n + j)*w],
// out_sign[pq*n + j].  Diagonal pairs emit I = J with sign = occupancy.
void gather_values(const uint32_t* strs, int64_t n, int w, int norb,
                   uint32_t* out_val, int8_t* out_sign) {
    std::vector<uint32_t> buf(w);
    for (int p = 0; p < norb; ++p) {
        for (int q = 0; q < norb; ++q) {
            int64_t base = (int64_t)(p * norb + q) * n;
            for (int64_t j = 0; j < n; ++j) {
                const uint32_t* J = strs + j * w;
                uint32_t* out = out_val + (base + j) * w;
                if (p == q) {
                    std::memcpy(out, J, w * sizeof(uint32_t));
                    out_sign[base + j] = get_bit(J, p) ? 1 : 0;
                    continue;
                }
                if (!get_bit(J, p) || get_bit(J, q)) {
                    std::memset(out, 0, w * sizeof(uint32_t));
                    out_sign[base + j] = 0;
                    continue;
                }
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                std::memcpy(out, buf.data(), w * sizeof(uint32_t));
                out_sign[base + j] = ((s1 + s2) & 1) ? -1 : 1;
            }
        }
    }
}

// Same-spin Slater-Condon neighbor VALUES: per row the candidate neighbor
// strings (packed) and signed matrix elements, membership-free.  Layout per
// row: [diagonal, singles, doubles] exactly like samespin_candidates; the
// diagonal slot stores J itself.
void samespin_values(const uint32_t* strs, int64_t n, int w, int norb,
                     int nelec, const double* h1, const double* eri,
                     uint32_t* out_nbr, double* out_val, int64_t cand_width) {
    const int nv = norb - nelec;
    const int64_t n4 = (int64_t)norb * norb * norb, n2 = (int64_t)norb * norb;
    auto E = [&](int a, int b, int c, int d) -> double {
        return eri[(int64_t)a * n4 + (int64_t)b * n2 + (int64_t)c * norb + d];
    };
    std::vector<int> occ(nelec), virt(nv);
    std::vector<uint32_t> buf(w);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        uint32_t* nbr_row = out_nbr + i * cand_width * w;
        double* val_row = out_val + i * cand_width;
        int oc = 0, vc = 0;
        for (int t = 0; t < norb; ++t) {
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
            else { if (vc < nv) virt[vc] = t; ++vc; }
        }
        if (oc != nelec || vc != nv) {
            std::memset(nbr_row, 0, cand_width * w * sizeof(uint32_t));
            for (int64_t c0 = 0; c0 < cand_width; ++c0) val_row[c0] = 0.0;
            continue;
        }
        int64_t c = 0;
        double diag = 0.0;
        for (int a = 0; a < oc; ++a) {
            int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < oc; ++b) {
                int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        std::memcpy(nbr_row + c * w, J, w * sizeof(uint32_t));
        val_row[c] = diag;
        ++c;
        for (int a = 0; a < oc; ++a) {
            for (int k = 0; k < vc; ++k, ++c) {
                int p = occ[a], q = virt[k];
                std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                flip_bit(buf.data(), p);
                flip_bit(buf.data(), q);
                double mf = h1[p * norb + q];
                for (int b = 0; b < oc; ++b) {
                    int kk = occ[b];
                    if (kk == p) continue;
                    mf += E(p, q, kk, kk) - E(p, kk, kk, q);
                }
                int s1 = popcount_below(buf.data(), w, q);
                int s2 = popcount_below(buf.data(), w, p) - (q < p ? 1 : 0);
                std::memcpy(nbr_row + c * w, buf.data(), w * sizeof(uint32_t));
                val_row[c] = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
            }
        }
        for (int a = 0; a < oc; ++a) {
            for (int b = a + 1; b < oc; ++b) {
                for (int k = 0; k < vc; ++k) {
                    for (int l = k + 1; l < vc; ++l, ++c) {
                        int p = occ[a], r = occ[b], q = virt[k], s = virt[l];
                        std::memcpy(buf.data(), J, w * sizeof(uint32_t));
                        flip_bit(buf.data(), p);
                        flip_bit(buf.data(), r);
                        flip_bit(buf.data(), q);
                        flip_bit(buf.data(), s);
                        std::memcpy(nbr_row + c * w, buf.data(), w * sizeof(uint32_t));
                        int par = popcount_below(buf.data(), w, q);
                        flip_bit(buf.data(), q);
                        par += popcount_below(buf.data(), w, s);
                        flip_bit(buf.data(), s);
                        par += popcount_below(buf.data(), w, r);
                        flip_bit(buf.data(), r);
                        par += popcount_below(buf.data(), w, p);
                        double g = (par & 1) ? -1.0 : 1.0;
                        val_row[c] = 0.5 * g * (E(p, q, r, s) + E(r, s, p, q)
                                                - E(p, s, r, q) - E(r, q, p, s));
                    }
                }
            }
        }
        for (; c < cand_width; ++c) {
            std::memset(nbr_row + c * w, 0, w * sizeof(uint32_t));
            val_row[c] = 0.0;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Intersection-driven same-spin tables (sparse-set algorithm).
//
// The enumeration kernel above visits all 1 + ne*nv + C(ne,2)*C(nv,2)
// candidates per string and binary-searches each against the set — at high
// filling (e.g. 27e in 36o: 12,880 candidates/row) almost all of them miss
// a selected set.  This variant scales with OUTPUT + M*C(ne,2) instead:
// two strings are single- (double-) connected iff they share a one-hole
// (two-hole) intermediate, i.e. their intersection; sorting the M*ne one-hole
// and M*C(ne,2) two-hole cores groups exactly the connected pairs, with the
// partner's row index read straight off the bucket (no searches at all).
// Entries are emitted with their ENUMERATION SLOT and sorted by it per row,
// so the compacted output is bit-identical to the enumeration kernel's
// (same widths, same order, same values) — callers and caches can't tell
// the algorithms apart.
// ---------------------------------------------------------------------------

namespace {

struct HoleKeys {
    // one entry per (row, hole-subset): the core string J minus the holes.
    std::vector<uint32_t> cores;  // (count, w)
    std::vector<int32_t> rows;    // (count)
    std::vector<int64_t> order;   // sorted by core (lexicographic)
};

void build_hole_keys(const uint32_t* strs, int64_t n, int w, int norb,
                     int nelec, int nholes, HoleKeys& hk) {
    const int64_t per_row =
        nholes == 1 ? nelec : (int64_t)nelec * (nelec - 1) / 2;
    hk.cores.assign((size_t)(n * per_row) * w, 0u);
    hk.rows.assign((size_t)(n * per_row), 0);
    int64_t count = 0;
    std::vector<int> occ(norb);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        int oc = 0;
        for (int t = 0; t < norb; ++t)
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
        if (oc != nelec) continue;  // inert row (validated upstream)
        if (nholes == 1) {
            for (int a = 0; a < oc; ++a) {
                uint32_t* core = hk.cores.data() + count * w;
                std::memcpy(core, J, w * sizeof(uint32_t));
                flip_bit(core, occ[a]);
                hk.rows[count++] = (int32_t)i;
            }
        } else {
            for (int a = 0; a < oc; ++a) {
                for (int b = a + 1; b < oc; ++b) {
                    uint32_t* core = hk.cores.data() + count * w;
                    std::memcpy(core, J, w * sizeof(uint32_t));
                    flip_bit(core, occ[a]);
                    flip_bit(core, occ[b]);
                    hk.rows[count++] = (int32_t)i;
                }
            }
        }
    }
    hk.cores.resize((size_t)count * w);
    hk.rows.resize((size_t)count);
    hk.order.resize((size_t)count);
    for (int64_t k = 0; k < count; ++k) hk.order[k] = k;
    if (w <= 2) {
        // pack to u64 keys: direct sort is several times faster than the
        // indirect comparator (one cache line per compare instead of three)
        std::vector<std::pair<uint64_t, int64_t>> keyed((size_t)count);
        for (int64_t k = 0; k < count; ++k) {
            const uint32_t* c = hk.cores.data() + k * w;
            uint64_t key = (uint64_t)c[0] | (w > 1 ? ((uint64_t)c[1] << 32) : 0u);
            keyed[k] = {key, k};
        }
        std::sort(keyed.begin(), keyed.end());
        for (int64_t k = 0; k < count; ++k) hk.order[k] = keyed[k].second;
    } else {
        const uint32_t* cores = hk.cores.data();
        std::sort(hk.order.begin(), hk.order.end(), [cores, w](int64_t x, int64_t y) {
            return row_less(cores + x * w, cores + y * w, w);
        });
    }
}

inline bool cores_equal(const HoleKeys& hk, int w, int64_t a, int64_t b) {
    return std::memcmp(hk.cores.data() + hk.order[a] * w,
                       hk.cores.data() + hk.order[b] * w,
                       w * sizeof(uint32_t)) == 0;
}

inline int popcount_xor(const uint32_t* a, const uint32_t* b, int w) {
    int acc = 0;
    for (int j = 0; j < w; ++j) acc += __builtin_popcount(a[j] ^ b[j]);
    return acc;
}

// Extract the (at most two) set bits of a XOR b; returns how many.
inline int xor_bits(const uint32_t* a, const uint32_t* b, int w, int* out) {
    int cnt = 0;
    for (int j = 0; j < w && cnt < 2; ++j) {
        uint32_t x = a[j] ^ b[j];
        while (x && cnt < 2) {
            out[cnt++] = j * 32 + __builtin_ctz(x);
            x &= x - 1;
        }
    }
    return cnt;
}

struct SparseEntry {
    int32_t slot;
    int32_t idx;
    double val;
};

// Walk both sorted hole-key lists computing each connected pair's matrix
// element; entries with an exactly-zero element are skipped in BOTH passes
// (matching the enumeration path's `val != 0` compaction — structured
// integrals like Hubbard zero out whole excitation classes).  When `fill`
// the entries land at per-row cursors, otherwise only `row_counts` grows.
void samespin_sparse_sweep(const uint32_t* strs, int64_t n, int w, int norb,
                           int nelec, const double* h1, const double* eri,
                           bool fill, int64_t* row_counts,
                           std::vector<SparseEntry>* entries,
                           const int64_t* row_ptr) {
    const int nv = norb - nelec;
    const int64_t n4 = (int64_t)norb * norb * norb, n2 = (int64_t)norb * norb;
    auto E = [&](int a, int b, int c, int d) -> double {
        return eri[(int64_t)a * n4 + (int64_t)b * n2 + (int64_t)c * norb + d];
    };
    std::vector<int64_t> cursor;
    if (fill) cursor.assign(row_ptr, row_ptr + n);
    // diagonal (slot 0) — emitted for every weight-valid row
    std::vector<int> occ(norb);
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* J = strs + i * w;
        int oc = 0;
        for (int t = 0; t < norb; ++t)
            if (get_bit(J, t)) { if (oc < nelec) occ[oc] = t; ++oc; }
        if (oc != nelec) continue;
        double diag = 0.0;
        for (int a = 0; a < oc; ++a) {
            int p = occ[a];
            diag += h1[p * norb + p];
            for (int b = 0; b < oc; ++b) {
                int q = occ[b];
                diag += 0.5 * (E(p, p, q, q) - E(p, q, q, p));
            }
        }
        if (diag == 0.0) continue;
        if (fill) (*entries)[cursor[i]++] = {0, (int32_t)i, diag};
        else ++row_counts[i];
    }
    int bits_j[2], bits_i[2];
    std::vector<uint32_t> buf(w);
    // singles via one-hole cores
    {
        HoleKeys hk;
        build_hole_keys(strs, n, w, norb, nelec, 1, hk);
        const int64_t cnt = (int64_t)hk.rows.size();
        for (int64_t lo = 0; lo < cnt;) {
            int64_t hi = lo + 1;
            while (hi < cnt && cores_equal(hk, w, lo, hi)) ++hi;
            for (int64_t a = lo; a < hi; ++a) {
                const int32_t rj = hk.rows[hk.order[a]];
                const uint32_t* Jj = strs + (int64_t)rj * w;
                const uint32_t* core = hk.cores.data() + hk.order[a] * w;
                xor_bits(Jj, core, w, bits_j);
                const int p = bits_j[0];  // the hole: occupied in Jj
                for (int64_t b = lo; b < hi; ++b) {
                    if (b == a) continue;
                    const int32_t ri = hk.rows[hk.order[b]];
                    const uint32_t* Ji = strs + (int64_t)ri * w;
                    const uint32_t* corei = hk.cores.data() + hk.order[b] * w;
                    xor_bits(Ji, corei, w, bits_i);
                    const int q = bits_i[0];  // virtual in Jj, occupied in Ji
                    double mf = h1[p * norb + q];
                    int oc2 = 0;
                    for (int t = 0; t < norb && oc2 < nelec; ++t) {
                        if (!get_bit(Jj, t)) continue;
                        ++oc2;
                        if (t == p) continue;
                        mf += E(p, q, t, t) - E(p, t, t, q);
                    }
                    const int s1 = popcount_below(Ji, w, q);
                    const int s2 = popcount_below(Ji, w, p) - (q < p ? 1 : 0);
                    const double val = (((s1 + s2) & 1) ? -1.0 : 1.0) * mf;
                    if (val == 0.0) continue;
                    if (!fill) {
                        ++row_counts[rj];
                        continue;
                    }
                    const int apos = popcount_below(Jj, w, p);
                    const int kpos = q - popcount_below(Jj, w, q);
                    const int32_t slot = (int32_t)(1 + apos * nv + kpos);
                    (*entries)[cursor[rj]++] = {slot, ri, val};
                }
            }
            lo = hi;
        }
    }
    // doubles via two-hole cores
    if (nelec >= 2 && nv >= 2) {
        HoleKeys hk;
        build_hole_keys(strs, n, w, norb, nelec, 2, hk);
        const int64_t cnt = (int64_t)hk.rows.size();
        const int64_t nvp = (int64_t)nv * (nv - 1) / 2;
        for (int64_t lo = 0; lo < cnt;) {
            int64_t hi = lo + 1;
            while (hi < cnt && cores_equal(hk, w, lo, hi)) ++hi;
            for (int64_t a = lo; a < hi; ++a) {
                const int32_t rj = hk.rows[hk.order[a]];
                const uint32_t* Jj = strs + (int64_t)rj * w;
                const uint32_t* core = hk.cores.data() + hk.order[a] * w;
                for (int64_t b = lo; b < hi; ++b) {
                    if (b == a) continue;
                    const int32_t ri = hk.rows[hk.order[b]];
                    const uint32_t* Ji = strs + (int64_t)ri * w;
                    if (popcount_xor(Jj, Ji, w) != 4) continue;  // single: 1-hole pass
                    xor_bits(Jj, core, w, bits_j);  // holes of Jj: p < r
                    xor_bits(Ji, core, w, bits_i);  // holes of Ji: q < s
                    const int p = bits_j[0], r = bits_j[1];
                    const int q = bits_i[0], s = bits_i[1];
                    const double raw = E(p, q, r, s) + E(r, s, p, q)
                                       - E(p, s, r, q) - E(r, q, p, s);
                    if (raw == 0.0) continue;
                    if (!fill) {
                        ++row_counts[rj];
                        continue;
                    }
                    std::memcpy(buf.data(), Ji, w * sizeof(uint32_t));
                    int par = popcount_below(buf.data(), w, q);
                    flip_bit(buf.data(), q);
                    par += popcount_below(buf.data(), w, s);
                    flip_bit(buf.data(), s);
                    par += popcount_below(buf.data(), w, r);
                    flip_bit(buf.data(), r);
                    par += popcount_below(buf.data(), w, p);
                    const double g = (par & 1) ? -1.0 : 1.0;
                    const double val = 0.5 * g * raw;
                    const int apos = popcount_below(Jj, w, p);
                    const int bpos = popcount_below(Jj, w, r);
                    const int kpos = q - popcount_below(Jj, w, q);
                    const int lpos = s - popcount_below(Jj, w, s);
                    const int64_t opair =
                        (int64_t)apos * nelec - (int64_t)apos * (apos + 1) / 2
                        + (bpos - apos - 1);
                    const int64_t vpair =
                        (int64_t)kpos * nv - (int64_t)kpos * (kpos + 1) / 2
                        + (lpos - kpos - 1);
                    const int32_t slot =
                        (int32_t)(1 + (int64_t)nelec * nv + opair * nvp + vpair);
                    (*entries)[cursor[rj]++] = {slot, ri, val};
                }
            }
            lo = hi;
        }
    }
}

}  // namespace

extern "C" {

// Per-row nonzero-neighbor counts (incl. the diagonal); returns the max.
// h1/eri are needed even for counting: zero matrix elements are dropped,
// exactly like the enumeration path's compaction.
int64_t samespin_sparse_count(const uint32_t* strs, int64_t n, int w,
                              int norb, int nelec, const double* h1,
                              const double* eri, int64_t* row_counts) {
    std::fill(row_counts, row_counts + n, (int64_t)0);
    samespin_sparse_sweep(strs, n, w, norb, nelec, h1, eri,
                          /*fill=*/false, row_counts, nullptr, nullptr);
    int64_t mx = 0;
    for (int64_t i = 0; i < n; ++i) mx = std::max(mx, row_counts[i]);
    return mx;
}

// Compacted (idx, val) rows, enumeration-slot order, zero-padded to `width`.
void samespin_sparse_fill(const uint32_t* strs, int64_t n, int w, int norb,
                          int nelec, const double* h1, const double* eri,
                          int32_t* out_idx, double* out_val, int64_t width) {
    std::vector<int64_t> counts((size_t)n, 0);
    samespin_sparse_sweep(strs, n, w, norb, nelec, h1, eri,
                          /*fill=*/false, counts.data(), nullptr, nullptr);
    std::vector<int64_t> row_ptr((size_t)n + 1, 0);
    for (int64_t i = 0; i < n; ++i) row_ptr[i + 1] = row_ptr[i] + counts[i];
    std::vector<SparseEntry> entries((size_t)row_ptr[n]);
    samespin_sparse_sweep(strs, n, w, norb, nelec, h1, eri,
                          /*fill=*/true, nullptr, &entries, row_ptr.data());
    for (int64_t i = 0; i < n; ++i) {
        SparseEntry* lo = entries.data() + row_ptr[i];
        SparseEntry* hi = entries.data() + row_ptr[i + 1];
        std::sort(lo, hi, [](const SparseEntry& x, const SparseEntry& y) {
            return x.slot < y.slot;
        });
        int32_t* idx_row = out_idx + i * width;
        double* val_row = out_val + i * width;
        int64_t c = 0;
        for (SparseEntry* e = lo; e < hi && c < width; ++e, ++c) {
            idx_row[c] = e->idx;
            val_row[c] = e->val;
        }
        for (; c < width; ++c) { idx_row[c] = 0; val_row[c] = 0.0; }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// McMurchie-Davidson molecular integrals (host kernel for sqd_tpu.chem)
//
// Same algorithm as sqd_tpu/chem/integrals.py (the NumPy fallback), in C++
// because the Python quartet loops cost ~40 s for N2/cc-pVDZ.  Supports
// l <= 2 Cartesian shells (s, p, 6d); the Python layer applies the
// Cartesian -> real-solid-harmonic transform.  Pinned against the Python
// path (1e-12) in tests/test_chem_native.py.
// ---------------------------------------------------------------------------

#include <cmath>

namespace md {

constexpr int LMAX = 2;           // highest shell angular momentum
constexpr int IMAX = LMAX + 1;    // bra Cartesian exponent 0..2
constexpr int JMAX = LMAX + 3;    // ket exponent 0..4 (kinetic +2)
constexpr int TMAX = IMAX + JMAX; // Hermite order upper bound
constexpr int RN = 4 * LMAX;      // max Boys order for ERI: 8
constexpr int RDIM = RN + 1;      // R-table axis extent

// Cartesian component triples per l, matching integrals.py _CART order.
static const int CART[3][6][3] = {
    {{0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}},
    {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}},
    {{2, 0, 0}, {1, 1, 0}, {1, 0, 1}, {0, 2, 0}, {0, 1, 1}, {0, 0, 2}},
};
static inline int ncomp(int l) { return (l + 1) * (l + 2) / 2; }

// F_n(x) for n = 0..nmax: series at the top order (all-positive terms, no
// cancellation) + stable downward recursion; pure asymptotic above x = 35
// where exp(-x) < 7e-16 makes upward recursion exact.
static void boys(int nmax, double x, double* F) {
    if (x < 1e-13) {
        for (int n = 0; n <= nmax; ++n) F[n] = 1.0 / (2.0 * n + 1.0);
        return;
    }
    if (x > 35.0) {
        F[0] = 0.5 * std::sqrt(M_PI / x);
        const double ex = std::exp(-x);
        for (int n = 0; n < nmax; ++n)
            F[n + 1] = ((2.0 * n + 1.0) * F[n] - ex) / (2.0 * x);
        return;
    }
    const double ex = std::exp(-x);
    double term = 1.0 / (2.0 * nmax + 1.0);
    double acc = term;
    for (int k = 0; k < 300; ++k) {
        term *= 2.0 * x / (2.0 * nmax + 2.0 * k + 3.0);
        acc += term;
        if (term < 1e-17 * acc) break;
    }
    F[nmax] = acc * ex;
    for (int n = nmax - 1; n >= 0; --n)
        F[n] = (2.0 * x * F[n + 1] + ex) / (2.0 * n + 1.0);
}

static inline int ridx(int n, int t, int u, int v) {
    return ((n * RDIM + t) * RDIM + u) * RDIM + v;
}

// Hermite Coulomb table: R[ridx(n,t,u,v)] for n+t+u+v <= N (N <= RN).
static void hermite_R(int N, double p, const double* pc, double* R) {
    double F[RN + 1];
    boys(N, p * (pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]), F);
    double m2p = 1.0;  // (-2p)^n
    for (int n = 0; n <= N; ++n) {
        R[ridx(n, 0, 0, 0)] = m2p * F[n];
        m2p *= -2.0 * p;
    }
    for (int n = N - 1; n >= 0; --n) {
        const int rem = N - n;
        for (int t = 0; t <= rem; ++t)
            for (int u = 0; u + t <= rem; ++u)
                for (int v = 0; v + t + u <= rem; ++v) {
                    if (t == 0 && u == 0 && v == 0) continue;
                    double val;
                    if (t > 0) {
                        val = pc[0] * R[ridx(n + 1, t - 1, u, v)];
                        if (t > 1) val += (t - 1) * R[ridx(n + 1, t - 2, u, v)];
                    } else if (u > 0) {
                        val = pc[1] * R[ridx(n + 1, t, u - 1, v)];
                        if (u > 1) val += (u - 1) * R[ridx(n + 1, t, u - 2, v)];
                    } else {
                        val = pc[2] * R[ridx(n + 1, t, u, v - 1)];
                        if (v > 1) val += (v - 1) * R[ridx(n + 1, t, u, v - 2)];
                    }
                    R[ridx(n, t, u, v)] = val;
                }
    }
}

// One Hermite product term of a bra/ket component pair.
struct HTerm {
    int t, u, v;
    double val;         // E^x * E^y * E^z
    double signed_val;  // val * (-1)^(t+u+v) (used when the pair is the ket)
};

struct PrimPair {
    double p, cc;
    double P[3];
    double E[3][IMAX][JMAX][TMAX];  // E[d][i][j][t]
};

struct ShellPair {
    int la, lb, ia_off, ib_off, sa, sb;
    std::vector<PrimPair> prims;
    // bra Hermite terms: [prim][comp_a * ncomp_b + comp_b] -> term list
    std::vector<std::vector<std::vector<HTerm>>> terms;
};

static void build_pair(const int* ls, const double* centers,
                       const int* prim_offs, const double* exps,
                       const double* coefs, int sa, int sb,
                       const int* ao_offs, ShellPair& sp) {
    sp.la = ls[sa];
    sp.lb = ls[sb];
    sp.sa = sa;
    sp.sb = sb;
    sp.ia_off = ao_offs[sa];
    sp.ib_off = ao_offs[sb];
    const double* A = centers + 3 * sa;
    const double* B = centers + 3 * sb;
    const int na = prim_offs[sa + 1] - prim_offs[sa];
    const int nb = prim_offs[sb + 1] - prim_offs[sb];
    sp.prims.resize((size_t)na * nb);
    sp.terms.resize((size_t)na * nb);
    const int nca = ncomp(sp.la), ncb = ncomp(sp.lb);
    int pp = 0;
    for (int ka = 0; ka < na; ++ka)
        for (int kb = 0; kb < nb; ++kb, ++pp) {
            const double a = exps[prim_offs[sa] + ka];
            const double b = exps[prim_offs[sb] + kb];
            PrimPair& q = sp.prims[pp];
            q.p = a + b;
            q.cc = coefs[prim_offs[sa] + ka] * coefs[prim_offs[sb] + kb];
            const double mu = a * b / q.p;
            const double inv2p = 0.5 / q.p;
            for (int d = 0; d < 3; ++d) {
                q.P[d] = (a * A[d] + b * B[d]) / q.p;
                const double pa = q.P[d] - A[d];
                const double pb = q.P[d] - B[d];
                const double ab = A[d] - B[d];
                auto& E = q.E[d];
                std::memset(E, 0, sizeof(q.E[d]));
                E[0][0][0] = std::exp(-mu * ab * ab);
                for (int i = 1; i <= sp.la; ++i)
                    for (int t = 0; t <= i; ++t) {
                        double val = pa * E[i - 1][0][t];
                        if (t > 0) val += inv2p * E[i - 1][0][t - 1];
                        if (t + 1 <= i - 1) val += (t + 1) * E[i - 1][0][t + 1];
                        E[i][0][t] = val;
                    }
                for (int j = 1; j <= sp.lb + 2; ++j)
                    for (int i = 0; i <= sp.la; ++i)
                        for (int t = 0; t <= i + j; ++t) {
                            double val = pb * E[i][j - 1][t];
                            if (t > 0) val += inv2p * E[i][j - 1][t - 1];
                            if (t + 1 <= i + j - 1) val += (t + 1) * E[i][j - 1][t + 1];
                            E[i][j][t] = val;
                        }
            }
            // bra Hermite product terms per component pair (ERI uses j <= lb)
            auto& tl = sp.terms[pp];
            tl.resize((size_t)nca * ncb);
            for (int ca = 0; ca < nca; ++ca)
                for (int cb = 0; cb < ncb; ++cb) {
                    const int ax = CART[sp.la][ca][0], ay = CART[sp.la][ca][1],
                              az = CART[sp.la][ca][2];
                    const int bx = CART[sp.lb][cb][0], by = CART[sp.lb][cb][1],
                              bz = CART[sp.lb][cb][2];
                    auto& lst = tl[(size_t)ca * ncb + cb];
                    for (int t = 0; t <= ax + bx; ++t) {
                        const double ex = q.E[0][ax][bx][t];
                        if (ex == 0.0) continue;
                        for (int u = 0; u <= ay + by; ++u) {
                            const double exy = ex * q.E[1][ay][by][u];
                            if (exy == 0.0) continue;
                            for (int v = 0; v <= az + bz; ++v) {
                                const double e3 = exy * q.E[2][az][bz][v];
                                if (e3 == 0.0) continue;
                                const double sgn = ((t + u + v) & 1) ? -1.0 : 1.0;
                                lst.push_back({t, u, v, e3, e3 * sgn});
                            }
                        }
                    }
                }
        }
}

}  // namespace md

extern "C" {

// Full Cartesian AO integrals: S, T, V (nao*nao) and ERI (nao^4, chemist).
// Shells must all have l <= 2.  Returns 0 on success, nonzero on bad input.
int ao_integrals_cart(int nshell, const int* ls, const double* centers,
                      const int* prim_offs, const double* exps,
                      const double* coefs, int natom, const double* charges,
                      const double* coords, int nao, double* S, double* T,
                      double* V, double* eri) {
    using namespace md;
    std::vector<int> ao_offs(nshell + 1, 0);
    for (int s = 0; s < nshell; ++s) {
        if (ls[s] < 0 || ls[s] > LMAX) return 1;
        ao_offs[s + 1] = ao_offs[s] + ncomp(ls[s]);
    }
    if (ao_offs[nshell] != nao) return 2;

    // shell pairs (i >= j), ordered like the Python dict: (i, j) ascending
    std::vector<ShellPair> pairs;
    pairs.reserve((size_t)nshell * (nshell + 1) / 2);
    for (int i = 0; i < nshell; ++i)
        for (int j = 0; j <= i; ++j) {
            pairs.emplace_back();
            build_pair(ls, centers, prim_offs, exps, coefs, i, j,
                       ao_offs.data(), pairs.back());
        }

    // ---- one-electron integrals ----
    std::vector<double> R((size_t)RDIM * RDIM * RDIM * RDIM);
    for (const ShellPair& sp : pairs) {
        const int nca = ncomp(sp.la), ncb = ncomp(sp.lb);
        const int lsum = sp.la + sp.lb;
        std::vector<double> sblk((size_t)nca * ncb, 0.0);
        std::vector<double> tblk((size_t)nca * ncb, 0.0);
        std::vector<double> vblk((size_t)nca * ncb, 0.0);
        const int nb = prim_offs[sp.sb + 1] - prim_offs[sp.sb];
        for (size_t pp = 0; pp < sp.prims.size(); ++pp) {
            const PrimPair& q = sp.prims[pp];
            const double b = exps[prim_offs[sp.sb] + (int)(pp % nb)];
            const double pref = std::pow(M_PI / q.p, 1.5) * q.cc;
            for (int ca = 0; ca < nca; ++ca)
                for (int cb = 0; cb < ncb; ++cb) {
                    double sd[3], kd[3];
                    for (int d = 0; d < 3; ++d) {
                        const int i = CART[sp.la][ca][d], j = CART[sp.lb][cb][d];
                        sd[d] = q.E[d][i][j][0];
                        kd[d] = b * (2 * j + 1) * q.E[d][i][j][0] -
                                2.0 * b * b * q.E[d][i][j + 2][0];
                        if (j >= 2) kd[d] -= 0.5 * j * (j - 1) * q.E[d][i][j - 2][0];
                    }
                    sblk[(size_t)ca * ncb + cb] += pref * sd[0] * sd[1] * sd[2];
                    tblk[(size_t)ca * ncb + cb] +=
                        pref * (kd[0] * sd[1] * sd[2] + sd[0] * kd[1] * sd[2] +
                                sd[0] * sd[1] * kd[2]);
                }
            // nuclear attraction: t+u+v of one pair is bounded by la+lb
            const double vpref = 2.0 * M_PI / q.p * q.cc;
            for (int at = 0; at < natom; ++at) {
                const double pc[3] = {q.P[0] - coords[3 * at],
                                      q.P[1] - coords[3 * at + 1],
                                      q.P[2] - coords[3 * at + 2]};
                hermite_R(lsum, q.p, pc, R.data());
                for (int ca = 0; ca < nca; ++ca)
                    for (int cb = 0; cb < ncb; ++cb) {
                        double acc = 0.0;
                        for (const HTerm& h : sp.terms[pp][(size_t)ca * ncb + cb])
                            acc += h.val * R[ridx(0, h.t, h.u, h.v)];
                        vblk[(size_t)ca * ncb + cb] -= charges[at] * vpref * acc;
                    }
            }
        }
        for (int ca = 0; ca < nca; ++ca)
            for (int cb = 0; cb < ncb; ++cb) {
                const int p = sp.ia_off + ca, r = sp.ib_off + cb;
                S[(size_t)p * nao + r] = sblk[(size_t)ca * ncb + cb];
                T[(size_t)p * nao + r] = tblk[(size_t)ca * ncb + cb];
                V[(size_t)p * nao + r] = vblk[(size_t)ca * ncb + cb];
                S[(size_t)r * nao + p] = S[(size_t)p * nao + r];
                T[(size_t)r * nao + p] = T[(size_t)p * nao + r];
                V[(size_t)r * nao + p] = V[(size_t)p * nao + r];
            }
    }

    // ---- two-electron integrals ----
    const size_t n2 = (size_t)nao * nao, n3 = n2 * nao;
    std::vector<double> blk;
    for (size_t A = 0; A < pairs.size(); ++A) {
        const ShellPair& ab = pairs[A];
        const int nca = ncomp(ab.la), ncb = ncomp(ab.lb);
        for (size_t C = 0; C <= A; ++C) {
            const ShellPair& cd = pairs[C];
            const int ncc = ncomp(cd.la), ncd = ncomp(cd.lb);
            const int N = ab.la + ab.lb + cd.la + cd.lb;
            blk.assign((size_t)nca * ncb * ncc * ncd, 0.0);
            for (size_t pa = 0; pa < ab.prims.size(); ++pa) {
                const PrimPair& qa = ab.prims[pa];
                for (size_t pc = 0; pc < cd.prims.size(); ++pc) {
                    const PrimPair& qc = cd.prims[pc];
                    const double alpha = qa.p * qc.p / (qa.p + qc.p);
                    const double pq[3] = {qa.P[0] - qc.P[0], qa.P[1] - qc.P[1],
                                          qa.P[2] - qc.P[2]};
                    hermite_R(N, alpha, pq, R.data());
                    const double pref =
                        2.0 * std::pow(M_PI, 2.5) /
                        (qa.p * qc.p * std::sqrt(qa.p + qc.p)) * qa.cc * qc.cc;
                    for (int cab = 0; cab < nca * ncb; ++cab) {
                        const auto& bra = ab.terms[pa][cab];
                        double* out_row = blk.data() + (size_t)cab * ncc * ncd;
                        for (int ccd = 0; ccd < ncc * ncd; ++ccd) {
                            const auto& ket = cd.terms[pc][ccd];
                            double acc = 0.0;
                            for (const HTerm& hb : bra)
                                for (const HTerm& hk : ket)
                                    acc += hb.val * hk.signed_val *
                                           R[ridx(0, hb.t + hk.t, hb.u + hk.u,
                                                  hb.v + hk.v)];
                            out_row[ccd] += pref * acc;
                        }
                    }
                }
            }
            // scatter into all 8 symmetric positions (matches _fill_eri)
            for (int ca = 0; ca < nca; ++ca)
                for (int cb = 0; cb < ncb; ++cb)
                    for (int cc = 0; cc < ncc; ++cc)
                        for (int cdx = 0; cdx < ncd; ++cdx) {
                            const double val =
                                blk[((size_t)(ca * ncb + cb) * ncc + cc) * ncd +
                                    cdx];
                            const size_t p = ab.ia_off + ca, q = ab.ib_off + cb;
                            const size_t r = cd.ia_off + cc, s = cd.ib_off + cdx;
                            eri[p * n3 + q * n2 + r * nao + s] = val;
                            eri[q * n3 + p * n2 + r * nao + s] = val;
                            eri[p * n3 + q * n2 + s * nao + r] = val;
                            eri[q * n3 + p * n2 + s * nao + r] = val;
                            eri[r * n3 + s * n2 + p * nao + q] = val;
                            eri[s * n3 + r * n2 + p * nao + q] = val;
                            eri[r * n3 + s * n2 + q * nao + p] = val;
                            eri[s * n3 + r * n2 + q * nao + p] = val;
                        }
        }
    }
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Fused diagonal-Pauli matrix elements (single-core host fast path).
//
// For a Pauli with no X/Y component every subspace string connects to itself:
// amp_i = phase * (-1)^popcount(string_i AND z_mask), rows = cols = arange.
// The NumPy formulation walks the data in 4-5 separate passes (pack, mask,
// popcount, complex cast, arange copies) — on this VM's single core that is
// the whole cost of the reference's published like-for-like benchmark
// (benchmark_pauli_projection.ipynb cells 6-7, d = 5e7, 40 qubits).  These
// kernels stream the input once and write all three outputs in the same pass.

extern "C" {

// Input: row-major bool matrix (1 byte/entry, n x nq, column 0 = MSB / qubit
// nq-1), zsel = per-COLUMN 0/1 byte mask.  amps is interleaved complex128.
void pauli_diag_from_bool(const uint8_t* bm, int64_t n, int nq,
                          const uint8_t* zsel, double ph_re, double ph_im,
                          double* amps, int64_t* rows, int64_t* cols) {
    const int nfull = nq / 8;
    const int tail = nq - nfull * 8;
    std::vector<uint64_t> zw(nfull > 0 ? nfull : 1);
    for (int jj = 0; jj < nfull; ++jj) std::memcpy(&zw[jj], zsel + jj * 8, 8);
    for (int64_t i = 0; i < n; ++i) {
        const uint8_t* row = bm + i * nq;
        uint64_t acc = 0;
        for (int jj = 0; jj < nfull; ++jj) {
            uint64_t v;
            std::memcpy(&v, row + jj * 8, 8);
            acc ^= v & zw[jj];
        }
        int par = __builtin_popcountll(acc) & 1;
        for (int c = nfull * 8; c < nfull * 8 + tail; ++c)
            par ^= (row[c] & zsel[c]) & 1;
        const double s = par ? -1.0 : 1.0;
        amps[2 * i] = s * ph_re;
        amps[2 * i + 1] = s * ph_im;
        rows[i] = i;
        cols[i] = i;
    }
}

// Same contract over packed little-endian uint32 words.
void pauli_diag_from_packed(const uint32_t* packed, int64_t n, int w,
                            const uint32_t* zw, double ph_re, double ph_im,
                            double* amps, int64_t* rows, int64_t* cols) {
    for (int64_t i = 0; i < n; ++i) {
        const uint32_t* row = packed + i * w;
        int acc = 0;
        for (int j = 0; j < w; ++j) acc += __builtin_popcount(row[j] & zw[j]);
        const double s = (acc & 1) ? -1.0 : 1.0;
        amps[2 * i] = s * ph_re;
        amps[2 * i + 1] = s * ph_im;
        rows[i] = i;
        cols[i] = i;
    }
}

}  // extern "C"
