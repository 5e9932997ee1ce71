/*
 * C ABI over the cxxnet_tpu_torch trainer + data iterators (the same
 * CXN* prototypes as the JAX package's native/cxxnet_wrapper.h).
 *
 * Capability parity with the reference C wrapper
 * (wrapper/cxxnet_wrapper.h:28-229): create/configure/train/predict/
 * extract/evaluate nets and drive config-built data iterators from any
 * C-ABI language. The implementation (cxxnet_wrapper.cc) embeds CPython
 * and delegates to cxxnet_tpu_torch.capi; the PyTorch compute path
 * underneath (the hand-written CUDA kernels on the card) is exactly the
 * one the Python API uses. CXNNetCreate's device: "cpu" is the CPU;
 * "gpu", "cuda", "tpu" (and "", the default) mean the card.
 *
 * Conventions:
 *  - all functions return 0 / a handle / a count on success;
 *    -1 / NULL on failure. CXNGetLastError() describes the failure.
 *  - float buffers are caller-owned, row-major float32.
 *  - shapes are uint64[4] (batch, channel, height, width).
 */
#ifndef CXXNET_TPU_TORCH_WRAPPER_H_
#define CXXNET_TPU_TORCH_WRAPPER_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void *CXNNetHandle;
typedef void *CXNIOHandle;

/* last error message of the calling thread (never NULL) */
const char *CXNGetLastError(void);

/* ---- net lifecycle ---------------------------------------------------- */
CXNNetHandle CXNNetCreate(const char *device, const char *cfg);
int CXNNetFree(CXNNetHandle h);
int CXNNetSetParam(CXNNetHandle h, const char *name, const char *val);
int CXNNetInitModel(CXNNetHandle h);
int CXNNetLoadModel(CXNNetHandle h, const char *fname);
int CXNNetSaveModel(CXNNetHandle h, const char *fname);
int CXNNetStartRound(CXNNetHandle h, int round_counter);

/* ---- training --------------------------------------------------------- */
int CXNNetUpdateIter(CXNNetHandle h, CXNIOHandle it);
int CXNNetUpdateBatch(CXNNetHandle h, const float *data,
                      const uint64_t dshape[4], const float *label,
                      uint64_t label_width);

/* ---- inference -------------------------------------------------------- */
/* returns number of floats written, -1 on error */
int64_t CXNNetPredictBatch(CXNNetHandle h, const float *data,
                           const uint64_t dshape[4], float *out);
int64_t CXNNetPredictIter(CXNNetHandle h, CXNIOHandle it, float *out,
                          uint64_t out_capacity);
int64_t CXNNetExtractBatch(CXNNetHandle h, const float *data,
                           const uint64_t dshape[4], const char *node_name,
                           float *out, uint64_t out_capacity);
/* evaluation string "\tname-metric:value..."; valid until the next call
 * on the same thread */
const char *CXNNetEvaluate(CXNNetHandle h, CXNIOHandle it,
                           const char *name);

/* ---- weight access ---------------------------------------------------- */
/* writes the 2-D flattened weight and its shape; returns element count,
 * 0 when no such weight exists, -1 on error */
int64_t CXNNetGetWeight(CXNNetHandle h, const char *layer_name,
                        const char *tag, float *out, uint64_t out_capacity,
                        uint64_t shape_out[2]);
int CXNNetSetWeight(CXNNetHandle h, const float *data, uint64_t rows,
                    uint64_t cols, const char *layer_name, const char *tag);

/* ---- data iterators ---------------------------------------------------- */
CXNIOHandle CXNIOCreateFromConfig(const char *cfg);
int CXNIOFree(CXNIOHandle h);
int CXNIONext(CXNIOHandle h);          /* 1 = has batch, 0 = end, -1 err */
int CXNIOBeforeFirst(CXNIOHandle h);
int CXNIOGetDataShape(CXNIOHandle h, uint64_t shape_out[4]);
int64_t CXNIOCopyData(CXNIOHandle h, float *out);
int CXNIOGetLabelShape(CXNIOHandle h, uint64_t shape_out[2]);
int64_t CXNIOCopyLabel(CXNIOHandle h, float *out);

#ifdef __cplusplus
}  /* extern "C" */
#endif
#endif  /* CXXNET_TPU_TORCH_WRAPPER_H_ */
