// Native runtime components for anyseq_tpu.
//
// Re-design of the reference's C++ host layer
// (src/sequence_io.cpp, src/traceback.impala:47-80): the compute path is
// JAX (and a CUDA sweep kernel on the GPU); the host-side sequential pieces -- record parsing and the
// inherently serial traceback walks -- are native for speed. Exposed as a
// C ABI consumed via ctypes (anyseq_tpu/io/_native.py).
//
// Build: g++ -O2 -shared -fPIC -o libanyseq_native.so anyseq_native.cpp

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------------
// FASTA/FASTQ first-record readers (reference: sequence_io.cpp:62-163,
// first-record-only semantics of main.cpp:182-189).
// Returns sequence length, -1 on open failure, -2 on format error,
// -3 if capacity insufficient (call again with a larger buffer).
// ---------------------------------------------------------------------
long read_first_fasta(const char* path, unsigned char* out, long cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    static const long BUF = 1 << 20;
    char* line = (char*)malloc(BUF);
    if (!fgets(line, BUF, f)) { free(line); fclose(f); return -2; }
    if (line[0] != '>') { free(line); fclose(f); return -2; }
    long n = 0;
    while (fgets(line, BUF, f)) {
        if (line[0] == '>') break;
        long len = (long)strlen(line);
        while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            --len;
        if (n + len > cap) { free(line); fclose(f); return -3; }
        memcpy(out + n, line, (size_t)len);
        n += len;
    }
    free(line);
    fclose(f);
    return n > 0 ? n : -2;
}

long read_first_fastq(const char* path, unsigned char* out, long cap) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    static const long BUF = 1 << 20;
    char* line = (char*)malloc(BUF);
    long n = -2;
    if (fgets(line, BUF, f) && line[0] == '@' && fgets(line, BUF, f)) {
        long len = (long)strlen(line);
        while (len > 0 && (line[len - 1] == '\n' || line[len - 1] == '\r'))
            --len;
        if (len > cap) n = -3;
        else { memcpy(out, line, (size_t)len); n = len; }
    }
    free(line);
    fclose(f);
    return n;
}

// ---------------------------------------------------------------------
// Linear-gap traceback walk (reference: traceback.impala:47-80).
// P: haloed (m+1)x(n+1) row-major predecessor matrix (codes 0..3).
// Writes the sparse out buffers (out_pos = i+j+1+offsets, '_' gaps).
// start_out[0..1] receives the alignment start cell.
// ---------------------------------------------------------------------
static const unsigned char PRED_NONE = 0, PRED_GAP_Q = 1, PRED_GAP_S = 2,
                           PRED_NO_GAP = 3;
static const unsigned char GAP_SYM = '_';

void traceback_linear(const unsigned char* P, long m, long n, long ei,
                      long ej, const unsigned char* q,
                      const unsigned char* s, unsigned char* out_q,
                      unsigned char* out_s, long off, long* start_out) {
    long i = ei, j = ej;
    long W = n + 1;
    unsigned char pred = P[(i + 1) * W + (j + 1)];
    while (pred != PRED_NONE) {
        unsigned char sym_q = GAP_SYM, sym_s = GAP_SYM;
        long out_pos = i + j + 1 + off;
        if (pred == PRED_NO_GAP || pred == PRED_GAP_S) { sym_q = q[i]; --i; }
        if (pred == PRED_NO_GAP || pred == PRED_GAP_Q) { sym_s = s[j]; --j; }
        out_q[out_pos] = sym_q;
        out_s[out_pos] = sym_s;
        pred = P[(i + 1) * W + (j + 1)];
    }
    start_out[0] = i + 1;
    start_out[1] = j + 1;
}

// ---------------------------------------------------------------------
// Affine (Gotoh) 3-state traceback walk (see ref/oracle_affine.py).
// PH codes 0..3; PE/PF: 0 = opened, 1 = extended.
// ---------------------------------------------------------------------
void traceback_affine(const unsigned char* PH, const unsigned char* PE,
                      const unsigned char* PF, long m, long n, long ei,
                      long ej, const unsigned char* q,
                      const unsigned char* s, unsigned char* out_q,
                      unsigned char* out_s, long off, long* start_out) {
    long i = ei, j = ej;
    long W = n + 1;
    int state = 0;  // 0=H 1=E 2=F
    for (;;) {
        if (state == 0) {
            unsigned char pred = PH[(i + 1) * W + (j + 1)];
            if (pred == PRED_NONE) break;
            if (pred == PRED_NO_GAP) {
                long out_pos = i + j + 1 + off;
                out_q[out_pos] = q[i];
                out_s[out_pos] = s[j];
                --i; --j;
            } else if (pred == PRED_GAP_Q) {
                state = 1;
            } else {
                state = 2;
            }
        } else if (state == 1) {
            long out_pos = i + j + 1 + off;
            out_q[out_pos] = GAP_SYM;
            out_s[out_pos] = s[j];
            int opened = PE[(i + 1) * W + (j + 1)] == 0;
            --j;
            if (opened) state = 0;
        } else {
            long out_pos = i + j + 1 + off;
            out_q[out_pos] = q[i];
            out_s[out_pos] = GAP_SYM;
            int opened = PF[(i + 1) * W + (j + 1)] == 0;
            --i;
            if (opened) state = 0;
        }
        if (i < 0 && j < 0) break;
    }
    start_out[0] = i + 1;
    start_out[1] = j + 1;
}

// ---------------------------------------------------------------------
// Reference-parity C ABI (reference: src/import.h:14-41): the six
// pre-configured entry points, hard-coded linear_scoring_scheme(2,-1,-1)
// like the reference (export.impala:13-14), plus the three *_fulltb
// variants (export.impala:38,94,151) -- here with the CORRECT schemes
// (the reference's semiglobal/local fulltb use global_scheme by
// mistake; SURVEY.md quirk Q1). This is the native CPU surface for C
// callers; the accelerator path is the Python/JAX API. score_t is int64
// (datatypes.h:15). Deviation (SURVEY.md quirk Q6): construct_* return
// the true DP score (the reference's non-global construct scores read
// an unwritten matrix and are unreliable).
// ---------------------------------------------------------------------

enum { AMODE_GLOBAL = 0, AMODE_SEMIGLOBAL = 1, AMODE_LOCAL = 2 };
static const int A_MATCH = 2, A_MISMATCH = -1, A_GAP = -1;
static const long long A_MIN = -(1LL << 40);

static long long aseq_score(int mode, const unsigned char* q, long m,
                            const unsigned char* s, long n) {
    if (m <= 0 || n <= 0) return A_MIN;
    int* prev = (int*)malloc(sizeof(int) * (size_t)n);
    for (long j = 0; j < n; ++j)
        prev[j] = mode == AMODE_GLOBAL ? (int)(j + 1) * A_GAP : 0;
    long long best = A_MIN, col_max = A_MIN;
    for (long i = 0; i < m; ++i) {
        int diag = mode == AMODE_GLOBAL ? (int)i * A_GAP : 0;
        int left = mode == AMODE_GLOBAL ? (int)(i + 1) * A_GAP : 0;
        for (long j = 0; j < n; ++j) {
            int v = diag + (q[i] == s[j] ? A_MATCH : A_MISMATCH);
            int a = left + A_GAP;
            if (a > v) v = a;
            int b = prev[j] + A_GAP;
            if (b > v) v = b;
            if (mode == AMODE_LOCAL && v < 0) v = 0;
            diag = prev[j];
            prev[j] = v;
            left = v;
            if (mode == AMODE_LOCAL && v > best) best = v;
        }
        if (prev[n - 1] > col_max) col_max = prev[n - 1];
    }
    long long r;
    if (mode == AMODE_GLOBAL) {
        r = prev[n - 1];
    } else if (mode == AMODE_SEMIGLOBAL) {
        r = 0;  // empty-overlap boundary
        for (long j = 0; j < n; ++j)
            if (prev[j] > r) r = prev[j];
        if (col_max > r) r = col_max;
    } else {
        r = best < 0 ? 0 : best;
    }
    free(prev);
    return r;
}

static long long aseq_construct(int mode, const unsigned char* q, long m,
                                const unsigned char* s, long n,
                                unsigned char* alq, unsigned char* als) {
    if (m <= 0 || n <= 0) return A_MIN;
    memset(alq, ' ', (size_t)(m + n));
    memset(als, ' ', (size_t)(m + n));
    long Wp = n + 1;
    unsigned char* P = (unsigned char*)calloc((size_t)(m + 1) * Wp, 1);
    if (mode == AMODE_GLOBAL) {
        for (long j = 1; j <= n; ++j) P[j] = PRED_GAP_Q;
        for (long i = 1; i <= m; ++i) P[i * Wp] = PRED_GAP_S;
    }
    int* prev = (int*)malloc(sizeof(int) * (size_t)n);
    for (long j = 0; j < n; ++j)
        prev[j] = mode == AMODE_GLOBAL ? (int)(j + 1) * A_GAP : 0;
    long long best = A_MIN;
    long bi = -1, bj = -1;              // local argmax (first occurrence)
    long long row_max = 0, col_max = 0; // semiglobal, 0 = boundary
    long ri = m - 1, rj = -1, ci = -1, cj = n - 1;
    for (long i = 0; i < m; ++i) {
        int diag = mode == AMODE_GLOBAL ? (int)i * A_GAP : 0;
        int left = mode == AMODE_GLOBAL ? (int)(i + 1) * A_GAP : 0;
        for (long j = 0; j < n; ++j) {
            int dsub = diag + (q[i] == s[j] ? A_MATCH : A_MISMATCH);
            int a = left + A_GAP;
            int b = prev[j] + A_GAP;
            int v = dsub;
            if (a > v) v = a;
            if (b > v) v = b;
            if (mode == AMODE_LOCAL && v < 0) v = 0;
            unsigned char pr = PRED_NONE;  // clamped local zero
            if (v == dsub) pr = PRED_NO_GAP;       // diag first
            else if (v == a) pr = PRED_GAP_Q;      // then left
            else if (v == b) pr = PRED_GAP_S;      // then up
            P[(i + 1) * Wp + (j + 1)] = pr;
            diag = prev[j];
            prev[j] = v;
            left = v;
            if (mode == AMODE_LOCAL && v > best) {
                best = v; bi = i; bj = j;
            }
        }
        if (prev[n - 1] > col_max) { col_max = prev[n - 1]; ci = i; }
    }
    long ei, ej;
    long long score;
    if (mode == AMODE_GLOBAL) {
        ei = m - 1; ej = n - 1; score = prev[n - 1];
    } else if (mode == AMODE_SEMIGLOBAL) {
        for (long j = 0; j < n; ++j)
            if (prev[j] > row_max) { row_max = prev[j]; rj = j; }
        if (col_max > row_max) { score = col_max; ei = ci; ej = cj; }
        else { score = row_max; ei = ri; ej = rj; }
    } else {
        score = best < 0 ? 0 : best; ei = bi; ej = bj;
    }
    long start[2];
    if (ei >= 0 && ej >= 0)
        traceback_linear(P, m, n, ei, ej, q, s, alq, als, 0, start);
    free(prev);
    free(P);
    return score;
}

#define ASEQ_ENTRY(name, mode, construct)                                \
    long long name(const char* query, int lenq, const char* subject,     \
                   int lens, char* alQuery, char* alSubject) {           \
        (void)alQuery; (void)alSubject;                                  \
        if (construct)                                                   \
            return aseq_construct(mode, (const unsigned char*)query,     \
                                  lenq, (const unsigned char*)subject,   \
                                  lens, (unsigned char*)alQuery,         \
                                  (unsigned char*)alSubject);            \
        return aseq_score(mode, (const unsigned char*)query, lenq,       \
                          (const unsigned char*)subject, lens);          \
    }

long long global_alignment_score(const char* query, int lenq,
                                 const char* subject, int lens) {
    return aseq_score(AMODE_GLOBAL, (const unsigned char*)query, lenq,
                      (const unsigned char*)subject, lens);
}
long long semiglobal_alignment_score(const char* query, int lenq,
                                     const char* subject, int lens) {
    return aseq_score(AMODE_SEMIGLOBAL, (const unsigned char*)query,
                      lenq, (const unsigned char*)subject, lens);
}
long long local_alignment_score(const char* query, int lenq,
                                const char* subject, int lens) {
    return aseq_score(AMODE_LOCAL, (const unsigned char*)query, lenq,
                      (const unsigned char*)subject, lens);
}
ASEQ_ENTRY(construct_global_alignment, AMODE_GLOBAL, 1)
ASEQ_ENTRY(construct_semiglobal_alignment, AMODE_SEMIGLOBAL, 1)
ASEQ_ENTRY(construct_local_alignment, AMODE_LOCAL, 1)
ASEQ_ENTRY(construct_global_alignment_fulltb, AMODE_GLOBAL, 1)
ASEQ_ENTRY(construct_semiglobal_alignment_fulltb, AMODE_SEMIGLOBAL, 1)
ASEQ_ENTRY(construct_local_alignment_fulltb, AMODE_LOCAL, 1)

}  // extern "C"
