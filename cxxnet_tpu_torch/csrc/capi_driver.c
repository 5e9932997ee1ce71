/*
 * C driver of the cxxnet_tpu_torch C ABI (libcxxnetwrapper, built by
 * cxxnet_tpu_torch/capi_build.py; the port's counterpart of
 * native/test_driver.c). It trains, predicts, extracts, round-trips a
 * model file and gets / sets a weight, all through the CXN* entry
 * points, and exits 0 when every check passes.
 *
 *   capi_driver DEVICE NETCONF DATA MODEL LAYER STEPS OUTDIR [BAR]
 *
 * DEVICE   CXNNetCreate's device: cpu, gpu, cuda, tpu
 * NETCONF  a file holding the net's config (netconfig block + globals)
 * DATA     iter:FILE - batches from the iterator config in FILE (its
 *                      labels are scored: train accuracy > BAR, default
 *                      0.9, after STEPS updates)
 *          rand:B,C,H,W,K - one batch of B x C x H x W floats in
 *                      [-128, 128) with labels in [0, K) from a fixed
 *                      LCG, made once and fed to every update (no
 *                      accuracy bar)
 * MODEL    the model file to save and load back
 * LAYER    a layer whose "wmat" is read, changed, written and restored
 * STEPS    CXNNetUpdateBatch calls (the iterator wraps around)
 * OUTDIR   receives batch.f32 (the last batch), rows.f32 (its top[-1]
 *          rows from CXNNetExtractBatch) and shape.txt ("B C H W K")
 *
 * It prints "c-abi images/s: X" over the updates after the first (the
 * first builds the kernels and warms the device), then
 * "c-abi driver: all checks passed".
 */
#include "cxxnet_wrapper.h"

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#define CHECK(cond)                                                    \
  do {                                                                 \
    if (!(cond)) {                                                     \
      fprintf(stderr, "CHECK failed at %s:%d: %s (last error: %s)\n",  \
              __FILE__, __LINE__, #cond, CXNGetLastError());           \
      exit(1);                                                         \
    }                                                                  \
  } while (0)

static char *read_file(const char *path) {
  FILE *f = fopen(path, "rb");
  CHECK(f != NULL);
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc((size_t)n + 1);
  CHECK(fread(buf, 1, (size_t)n, f) == (size_t)n);
  buf[n] = '\0';
  fclose(f);
  return buf;
}

static void write_file(const char *dir, const char *name, const void *p,
                       size_t bytes) {
  char path[4096];
  snprintf(path, sizeof(path), "%s/%s", dir, name);
  FILE *f = fopen(path, "wb");
  CHECK(f != NULL);
  CHECK(fwrite(p, 1, bytes, f) == bytes);
  fclose(f);
}

static double now_s(void) {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

/* deterministic LCG (the rand: batches) */
static unsigned long long lcg_state = 12345;
static double lcg(void) {
  lcg_state = lcg_state * 6364136223846793005ULL + 1442695040888963407ULL;
  return (double)((lcg_state >> 11) & 0xFFFFFFFF) / 4294967296.0;
}

/* where batches come from: an iterator handle, or the LCG */
typedef struct {
  CXNIOHandle it;
  uint64_t shape[4];
  uint64_t nclass;
  float *data;
  float *label;
  int made; /* the rand: batch is made once */
} Source;

static uint64_t numel(const uint64_t s[4]) {
  return s[0] * s[1] * s[2] * s[3];
}

/* the next batch into src->data / src->label; returns its row count */
static uint64_t next_batch(Source *src) {
  if (src->it == NULL) {
    if (src->made) return src->shape[0];
    src->made = 1;
    uint64_t n = numel(src->shape);
    for (uint64_t i = 0; i < n; ++i)
      src->data[i] = (float)(lcg() * 256.0 - 128.0);
    for (uint64_t i = 0; i < src->shape[0]; ++i)
      src->label[i] = (float)(int)(lcg() * (double)src->nclass);
    return src->shape[0];
  }
  int r = CXNIONext(src->it);
  CHECK(r >= 0);
  if (r == 0) {
    CHECK(CXNIOBeforeFirst(src->it) == 0);
    CHECK(CXNIONext(src->it) == 1);
  }
  uint64_t ds[4], ls[2];
  CHECK(CXNIOGetDataShape(src->it, ds) == 0);
  CHECK(ds[0] == src->shape[0] && numel(ds) == numel(src->shape));
  CHECK(CXNIOCopyData(src->it, src->data) == (int64_t)numel(ds));
  CHECK(CXNIOGetLabelShape(src->it, ls) == 0);
  CHECK(ls[0] == ds[0] && ls[1] >= 1);
  float *lab = (float *)malloc(sizeof(float) * ls[0] * ls[1]);
  CHECK(CXNIOCopyLabel(src->it, lab) == (int64_t)(ls[0] * ls[1]));
  for (uint64_t i = 0; i < ls[0]; ++i) src->label[i] = lab[i * ls[1]];
  free(lab);
  return ds[0];
}

int main(int argc, char **argv) {
  if (argc < 8) {
    fprintf(stderr, "usage: %s DEVICE NETCONF iter:FILE|rand:B,C,H,W,K "
                    "MODEL LAYER STEPS OUTDIR [BAR]\n", argv[0]);
    return 2;
  }
  const char *device = argv[1];
  char *net_cfg = read_file(argv[2]);
  const char *data_spec = argv[3];
  const char *model_path = argv[4];
  const char *layer = argv[5];
  int steps = atoi(argv[6]);
  const char *outdir = argv[7];
  double bar = argc > 8 ? atof(argv[8]) : 0.9;
  CHECK(steps >= 2);

  Source src;
  memset(&src, 0, sizeof(src));
  char *iter_cfg = NULL;
  if (strncmp(data_spec, "iter:", 5) == 0) {
    iter_cfg = read_file(data_spec + 5);
    src.it = CXNIOCreateFromConfig(iter_cfg);
    CHECK(src.it != NULL);
    CHECK(CXNIONext(src.it) == 1);
    CHECK(CXNIOGetDataShape(src.it, src.shape) == 0);
    CHECK(CXNIOBeforeFirst(src.it) == 0);
    src.nclass = 0;
  } else {
    unsigned long long b, c, h, w, k;
    CHECK(sscanf(data_spec, "rand:%llu,%llu,%llu,%llu,%llu", &b, &c, &h,
                 &w, &k) == 5);
    src.shape[0] = b; src.shape[1] = c; src.shape[2] = h; src.shape[3] = w;
    src.nclass = k;
  }
  uint64_t b = src.shape[0];
  src.data = (float *)malloc(sizeof(float) * numel(src.shape));
  src.label = (float *)malloc(sizeof(float) * b);

  CXNNetHandle net = CXNNetCreate(device, net_cfg);
  CHECK(net != NULL);
  CHECK(CXNNetInitModel(net) == 0);

  /* training through CXNNetUpdateBatch */
  CHECK(CXNNetStartRound(net, 0) == 0);
  double t0 = 0.0;
  for (int step = 0; step < steps; ++step) {
    uint64_t rows = next_batch(&src);
    if (step == 1) t0 = now_s();
    CHECK(CXNNetUpdateBatch(net, src.data, src.shape, src.label, 1) == 0);
    CHECK(rows == b);
  }
  /* an update returns once its inputs are consumed, its step may still
   * run on the device: a small readback (the layer's bias) waits for
   * it before the clock stops */
  {
    float bias[4096];
    uint64_t bshape[2];
    CHECK(CXNNetGetWeight(net, layer, "bias", bias, 4096, bshape) >= 0);
  }
  double secs = now_s() - t0;
  printf("c-abi images/s: %.1f (%d steps of %llu after the first, "
         "%.3f s)\n", (double)(steps - 1) * (double)b / secs, steps - 1,
         (unsigned long long)b, secs);

  /* the iterator path: one update over its current batch, evaluate,
   * and the train accuracy over a pass */
  if (src.it != NULL) {
    CHECK(CXNIOBeforeFirst(src.it) == 0);
    CHECK(CXNIONext(src.it) == 1);
    CHECK(CXNNetUpdateIter(net, src.it) == 0);
    const char *ev = CXNNetEvaluate(net, src.it, "train");
    CHECK(ev != NULL);
    printf("c-abi evaluate:%s\n", ev);
    CHECK(CXNIOBeforeFirst(src.it) == 0);
    float *pred = (float *)malloc(sizeof(float) * b);
    int correct = 0, total = 0;
    while (CXNIONext(src.it) == 1) {
      uint64_t ls[2];
      CHECK(CXNIOCopyData(src.it, src.data) == (int64_t)numel(src.shape));
      CHECK(CXNIOGetLabelShape(src.it, ls) == 0);
      float *lab = (float *)malloc(sizeof(float) * ls[0] * ls[1]);
      CHECK(CXNIOCopyLabel(src.it, lab) == (int64_t)(ls[0] * ls[1]));
      CHECK(CXNNetPredictBatch(net, src.data, src.shape, pred)
            == (int64_t)b);
      for (uint64_t i = 0; i < b; ++i) {
        total += 1;
        if ((int)pred[i] == (int)lab[i * ls[1]]) correct += 1;
      }
      free(lab);
    }
    double acc = (double)correct / total;
    printf("c-abi train accuracy: %.3f over %d rows\n", acc, total);
    CHECK(acc > bar);
    /* CXNNetPredictIter: one prediction per row of the pass */
    float *all = (float *)malloc(sizeof(float) * (size_t)total);
    CHECK(CXNNetPredictIter(net, src.it, all, (uint64_t)total)
          == (int64_t)total);
    free(all);
    free(pred);
    /* the batch the rows below come from */
    CHECK(CXNIOBeforeFirst(src.it) == 0);
    next_batch(&src);
  }

  /* extract the top node of the last batch; predict must be its argmax */
  int64_t cap = (int64_t)b * 4096;
  float *rows = (float *)malloc(sizeof(float) * (size_t)cap);
  int64_t n = CXNNetExtractBatch(net, src.data, src.shape, "top[-1]", rows,
                                 (uint64_t)cap);
  CHECK(n > 0 && n % (int64_t)b == 0);
  uint64_t k = (uint64_t)(n / (int64_t)b);
  float *pred = (float *)malloc(sizeof(float) * b);
  CHECK(CXNNetPredictBatch(net, src.data, src.shape, pred) == (int64_t)b);
  for (uint64_t i = 0; i < b; ++i) {
    uint64_t best = 0;
    for (uint64_t j = 1; j < k; ++j)
      if (rows[i * k + j] > rows[i * k + best]) best = j;
    CHECK((uint64_t)pred[i] == best);
  }
  write_file(outdir, "batch.f32", src.data, sizeof(float) * numel(src.shape));
  write_file(outdir, "rows.f32", rows, sizeof(float) * (size_t)n);
  {
    char txt[256];
    int len = snprintf(txt, sizeof(txt), "%llu %llu %llu %llu %llu\n",
                       (unsigned long long)src.shape[0],
                       (unsigned long long)src.shape[1],
                       (unsigned long long)src.shape[2],
                       (unsigned long long)src.shape[3],
                       (unsigned long long)k);
    write_file(outdir, "shape.txt", txt, (size_t)len);
  }
  /* an output buffer too small is an error, not an overrun */
  CHECK(CXNNetExtractBatch(net, src.data, src.shape, "top[-1]", rows, 1)
        == -1);
  CHECK(strlen(CXNGetLastError()) > 0);

  /* model file round trip: a second net loads it and gives the same
   * rows, bit for bit */
  CHECK(CXNNetSaveModel(net, model_path) == 0);
  CXNNetHandle net2 = CXNNetCreate(device, net_cfg);
  CHECK(net2 != NULL);
  CHECK(CXNNetLoadModel(net2, model_path) == 0);
  float *rows2 = (float *)malloc(sizeof(float) * (size_t)n);
  CHECK(CXNNetExtractBatch(net2, src.data, src.shape, "top[-1]", rows2,
                           (uint64_t)n) == n);
  CHECK(memcmp(rows, rows2, sizeof(float) * (size_t)n) == 0);

  /* weight round trip */
  uint64_t wshape[2] = {0, 0};
  int64_t wcap = 64LL << 20;
  float *w = (float *)malloc(sizeof(float) * (size_t)wcap);
  int64_t nw = CXNNetGetWeight(net2, layer, "wmat", w, (uint64_t)wcap,
                               wshape);
  CHECK(nw > 0 && (uint64_t)nw == wshape[0] * wshape[1]);
  float keep = w[0];
  w[0] = keep + 1.5f;
  CHECK(CXNNetSetWeight(net2, w, wshape[0], wshape[1], layer, "wmat") == 0);
  float *w2 = (float *)malloc(sizeof(float) * (size_t)nw);
  CHECK(CXNNetGetWeight(net2, layer, "wmat", w2, (uint64_t)nw, wshape)
        == nw);
  CHECK(w2[0] == keep + 1.5f);
  CHECK(memcmp(w + 1, w2 + 1, sizeof(float) * (size_t)(nw - 1)) == 0);
  w[0] = keep;
  CHECK(CXNNetSetWeight(net2, w, wshape[0], wshape[1], layer, "wmat") == 0);
  CHECK(CXNNetExtractBatch(net2, src.data, src.shape, "top[-1]", rows2,
                           (uint64_t)n) == n);
  CHECK(memcmp(rows, rows2, sizeof(float) * (size_t)n) == 0);
  /* a missing tag gives 0; an unknown layer is an error */
  CHECK(CXNNetGetWeight(net2, layer, "nope", w, (uint64_t)wcap, wshape)
        == 0);
  CHECK(CXNNetGetWeight(net2, "no_such_layer", "wmat", w, 8, wshape) == -1);
  CHECK(strlen(CXNGetLastError()) > 0);

  if (src.it != NULL) CHECK(CXNIOFree(src.it) == 0);
  CHECK(CXNNetFree(net) == 0);
  CHECK(CXNNetFree(net2) == 0);
  free(w);
  free(w2);
  free(rows);
  free(rows2);
  free(pred);
  free(src.data);
  free(src.label);
  free(net_cfg);
  free(iter_cfg);
  printf("c-abi driver: all checks passed\n");
  return 0;
}
