/* anyseq_tpu native C ABI -- reference-parity entry points
 * (reference: src/import.h:14-41). Scoring is the reference's
 * hard-coded linear_scoring_scheme(2,-1,-1) (export.impala:13-14);
 * score_t is int64 (datatypes.h:15).
 *
 * construct_* write space-sparse aligned strings into alQuery/alSubject
 * (each of capacity lenq+lens): the aligned pair of DP cell (i, j) sits
 * at offset i+j+1, gaps are '_', unused slots ' ' (traceback.impala:
 * 47-80). They return the true DP score (deviation: the reference's
 * non-global construct scores are unreliable, SURVEY.md Q6). The
 * *_fulltb variants use the correct schemes (the reference's mistakenly
 * use the global scheme, SURVEY.md Q1).
 *
 * This is the native CPU surface; the accelerator path is the Python API
 * (import anyseq_tpu). Link against libanyseq_native.so.
 */
#ifndef ANYSEQ_TPU_NATIVE_H_
#define ANYSEQ_TPU_NATIVE_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

int64_t global_alignment_score(const char* query, int lenq,
                               const char* subject, int lens);
int64_t semiglobal_alignment_score(const char* query, int lenq,
                                   const char* subject, int lens);
int64_t local_alignment_score(const char* query, int lenq,
                              const char* subject, int lens);

int64_t construct_global_alignment(const char* query, int lenq,
                                   const char* subject, int lens,
                                   char* alQuery, char* alSubject);
int64_t construct_semiglobal_alignment(const char* query, int lenq,
                                       const char* subject, int lens,
                                       char* alQuery, char* alSubject);
int64_t construct_local_alignment(const char* query, int lenq,
                                  const char* subject, int lens,
                                  char* alQuery, char* alSubject);

int64_t construct_global_alignment_fulltb(const char* query, int lenq,
                                          const char* subject, int lens,
                                          char* alQuery, char* alSubject);
int64_t construct_semiglobal_alignment_fulltb(
    const char* query, int lenq, const char* subject, int lens,
    char* alQuery, char* alSubject);
int64_t construct_local_alignment_fulltb(const char* query, int lenq,
                                         const char* subject, int lens,
                                         char* alQuery, char* alSubject);

#ifdef __cplusplus
}
#endif

#endif /* ANYSEQ_TPU_NATIVE_H_ */
