// The native image decoder of cxxnet_tpu_torch: BinaryPage streaming plus
// a pool of nvJPEG decode workers with an ordered hand-off to Python.
//
// Replaces native/cxxnet_io.cc (the JAX package's `use_native` library,
// bound by cxxnet_tpu/io/native.py): the same page reader
// (ReaderMain :226-278), worker pool (WorkerMain :281), reorder buffer
// (Pipeline::Next :195) and C ABI shape (:347-401), with nvJPEG where
// libjpeg (DecodeJpeg :77) was. It is not a port of a Pallas kernel: the
// JAX package decodes on the host with a library, and this decodes on the
// card with one.
//
// What runs where: each image's Huffman decode runs on the worker's CPU
// thread (nvjpegDecode on a NVJPEG_BACKEND_HYBRID handle) and its IDCT on
// the card, into its planes at the file's own chroma subsampling (Y, Cb,
// Cr by NVJPEG_OUTPUT_YUV; R, G, B as coded by NVJPEG_OUTPUT_UNCHANGED;
// a grayscale file's Y by NVJPEG_OUTPUT_Y). The chroma upsampling and the
// colour conversion are this file's kernel, YccToRgb: libjpeg's upsampling
// (jdsample.c: the "fancy" triangular h2v1, h2v2 and h1v2 filters, sample
// replication where libjpeg replicates) and its integer YCbCr -> RGB
// tables (jdcolor.c build_ycc_rgb_table), the arithmetic PIL decodes with,
// so nvJPEG's own filter and rounding do not move the pixels off PIL's;
// R, G, B files are upsampled alone, and grayscale files replicate Y into
// the three planes, as libjpeg's gray_rgb_convert does. The result is CHW
// uint8 (R, G, B planes), copied into the worker's pinned buffer on its own
// non-blocking stream, which alone is synchronised.
//
// What bounds it: the kernel is bound by bytes (it reads each plane once,
// ~1.5 bytes a pixel at 4:2:0, and writes 3); per 256 x 256 image that is
// microseconds. The host's entropy decode, the launches and the 0.2 MB
// copy back over PCIe set the rate, so the design runs `decode_threads`
// workers side by side, each with its own nvjpeg handle, state, stream and
// buffers; they share nothing but the task queue.
//
// Blobs the decoder does not take come back raw (c == 0) for the caller to
// decode on the host, as cxxnet_io.cc's DecodeBlob (:127-141) hands back
// what libjpeg / libpng cannot: anything that is not a JPEG (PNG, PPM);
// 4-component JPEGs (CMYK, YCCK), which libjpeg does not convert to RGB
// either; JPEGs subsampled other than 4:4:4, 4:2:2, 4:2:0, 4:4:0 or
// 4:1:1 (4:1:0, which libjpeg decodes); and JPEG streams nvJPEG gives a
// bitstream verdict on (BAD_JPEG, JPEG_NOT_SUPPORTED, INCOMPLETE_BITSTREAM).
// Any other CUDA or nvJPEG error fails the stream (error kind 2).
//
// Counts: one process-wide counter of YccToRgb launches, taken where the
// kernel is launched (a worker's image, cxio_ycc_to_rgb), and one of raw
// hand-backs, taken where a worker leaves a blob raw (cxio_counters).
//
// All buffers are owned by the handle and valid until the next cxio_next /
// cxio_before_first / cxio_close on that handle.

#include <cuda_runtime.h>
#include <library_types.h>
#include <nvjpeg.h>

#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <initializer_list>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

constexpr int64_t kPageNumInts = 64 << 18;
constexpr int64_t kPageSize = 4 * kPageNumInts;  // 64 MiB

// error kinds of a failed stream (cxio_error_kind)
constexpr int kErrIO = 1;      // the .bin files: missing, truncated, corrupt
constexpr int kErrDevice = 2;  // a CUDA or nvJPEG error that is no verdict

// how a JPEG's components are coded (YccToRgb's `coding`)
constexpr int kYcc = 0;   // Y, Cb, Cr
constexpr int kRgb = 1;   // R, G, B (an Adobe marker with transform 0)
constexpr int kGray = 2;  // one component, Y
constexpr int kNoRgb = -1;  // CMYK / YCCK: libjpeg gives no RGB of them

// the process's counters (cxio_counters): YccToRgb launches, raw hand-backs
std::atomic<long long> g_launches{0};
std::atomic<long long> g_raw{0};

struct Decoded {
  std::vector<unsigned char> raw;     // the blob, when c == 0
  std::vector<float> chw;             // CHW float32 (out_mode 1)
  std::vector<unsigned char> chw_u8;  // CHW uint8 (out_mode 2)
  int h = 0, w = 0, c = 0;            // c == 0 -> raw holds the blob
};

bool IsVerdict(nvjpegStatus_t st) {
  return st == NVJPEG_STATUS_BAD_JPEG ||
         st == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         st == NVJPEG_STATUS_INCOMPLETE_BITSTREAM;
}

std::string CudaMsg(const char* what, cudaError_t e) {
  return std::string("cuda: ") + what + ": " + cudaGetErrorString(e);
}

std::string JpegMsg(const char* what, nvjpegStatus_t st) {
  return std::string("nvjpeg: ") + what + " returned status " +
         std::to_string(static_cast<int>(st));
}

// How a JPEG's components are coded, as libjpeg decides it (jdapimin.c
// default_decompress_parms): one component is grayscale, four have no RGB
// decode; of three, a JFIF marker says YCbCr, an Adobe marker says YCbCr
// unless its transform byte is 0, and with neither, component ids 'R',
// 'G', 'B' mean RGB. Markers are read up to the scan.
int Coding(const std::vector<unsigned char>& b) {
  bool jfif = false, adobe = false, adobe_ycc = false, rgb_ids = false;
  int ncomp = 3;
  size_t i = 2;
  while (i + 4 <= b.size() && b[i] == 0xFF) {
    const unsigned char m = b[i + 1];
    const size_t len = (static_cast<size_t>(b[i + 2]) << 8) | b[i + 3];
    if (m == 0xDA || len < 2 || i + 2 + len > b.size()) break;
    const unsigned char* seg = b.data() + i + 4;
    if (m == 0xE0 && len >= 7 && std::memcmp(seg, "JFIF", 4) == 0) jfif = true;
    if (m == 0xEE && len >= 14 && std::memcmp(seg, "Adobe", 5) == 0) {
      adobe = true;
      adobe_ycc = seg[11] != 0;
    }
    const bool sof = m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xC8 &&
                     m != 0xCC;
    if (sof && len >= 8) ncomp = seg[5];
    if (sof && len >= 17)
      rgb_ids = seg[6] == 'R' && seg[9] == 'G' && seg[12] == 'B';
    i += 2 + len;
  }
  if (ncomp == 1) return kGray;
  if (ncomp != 3) return kNoRgb;
  if (jfif) return kYcc;
  if (adobe) return adobe_ycc ? kYcc : kRgb;
  return rgb_ids ? kRgb : kYcc;
}

// One chroma sample upsampled as libjpeg gives it at output pixel (x, y)
// (jdsample.c jinit_upsampler). Its fancy filters: horizontally (hf == 2)
// 3/4 of the nearer sample and 1/4 of the further, vertically (vf == 2)
// likewise (on column sums for h2v2), with libjpeg's rounding biases;
// neighbours past an edge are the edge sample, as libjpeg's context rows
// and edge columns make them. h2v1 and h2v2 take them only where the plane
// is more than 2 samples wide, h1v2 always; everything else (4:1:1, the
// narrow planes) replicates the sample.
__device__ __forceinline__ int Upsample(const unsigned char* c, int cw,
                                        int ch, int x, int y, int hf,
                                        int vf) {
  const int ix = x / hf;
  const int iy = y / vf;
  if (hf == 1 && vf == 2) {  // 4:4:0 (h1v2)
    const int iy2 = min(max((y & 1) ? iy + 1 : iy - 1, 0), ch - 1);
    return (3 * c[iy * cw + ix] + c[iy2 * cw + ix] + ((y & 1) ? 2 : 1)) >>
           2;
  }
  if (hf != 2 || cw <= 2) return c[iy * cw + ix];
  const int jx = min(max((x & 1) ? ix + 1 : ix - 1, 0), cw - 1);
  if (vf == 2) {  // 4:2:0 (h2v2)
    const int iy2 = min(max((y & 1) ? iy + 1 : iy - 1, 0), ch - 1);
    const int near = 3 * c[iy * cw + ix] + c[iy2 * cw + ix];
    const int far = 3 * c[iy * cw + jx] + c[iy2 * cw + jx];
    return (3 * near + far + ((x & 1) ? 7 : 8)) >> 4;
  }
  // 4:2:2 (h2v1)
  return (3 * c[iy * cw + ix] + c[iy * cw + jx] + ((x & 1) ? 2 : 1)) >> 2;
}

__device__ __forceinline__ unsigned char Clamp255(int v) {
  return static_cast<unsigned char>(min(max(v, 0), 255));
}

// Planar Y (w x h), Cb and Cr (cw x ch) -> CHW uint8 RGB: one thread a
// pixel, a block a strip of a row. libjpeg's tables: FIX(x) = x * 2^16
// rounded; R and B take the rounded products, G the floor of the
// summed products plus one half. An R, G, B file (kRgb) takes its
// upsampled planes as they are; a grayscale one (kGray, no chroma
// planes) writes Y to all three.
__global__ void YccToRgb(const unsigned char* __restrict__ yp,
                         const unsigned char* __restrict__ cbp,
                         const unsigned char* __restrict__ crp, int w, int h,
                         int cw, int ch, int hf, int vf, int coding,
                         unsigned char* __restrict__ out) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w) return;
  const int lum = yp[static_cast<size_t>(y) * w + x];
  const size_t plane = static_cast<size_t>(w) * h;
  const size_t at = static_cast<size_t>(y) * w + x;
  if (coding == kGray) {
    out[at] = out[plane + at] = out[2 * plane + at] =
        static_cast<unsigned char>(lum);
    return;
  }
  const int c1 = Upsample(cbp, cw, ch, x, y, hf, vf);
  const int c2 = Upsample(crp, cw, ch, x, y, hf, vf);
  if (coding == kRgb) {
    out[at] = static_cast<unsigned char>(lum);
    out[plane + at] = static_cast<unsigned char>(c1);
    out[2 * plane + at] = static_cast<unsigned char>(c2);
    return;
  }
  const int cb = c1 - 128, cr = c2 - 128;
  out[at] = Clamp255(lum + ((91881 * cr + 32768) >> 16));
  out[plane + at] =
      Clamp255(lum + ((-22554 * cb + 32768 - 46802 * cr) >> 16));
  out[2 * plane + at] = Clamp255(lum + ((116130 * cb + 32768) >> 16));
}

// the (horizontal, vertical) chroma factors of the subsamplings YccToRgb
// takes: 4:4:4, 4:2:2, 4:2:0, 4:4:0 and 4:1:1
bool Factors(nvjpegChromaSubsampling_t ss, int* hf, int* vf) {
  switch (ss) {
    case NVJPEG_CSS_444: *hf = 1; *vf = 1; return true;
    case NVJPEG_CSS_422: *hf = 2; *vf = 1; return true;
    case NVJPEG_CSS_420: *hf = 2; *vf = 2; return true;
    case NVJPEG_CSS_440: *hf = 1; *vf = 2; return true;
    case NVJPEG_CSS_411: *hf = 4; *vf = 1; return true;
    default: return false;
  }
}

bool FactorsTaken(int hf, int vf) {
  for (nvjpegChromaSubsampling_t ss :
       {NVJPEG_CSS_444, NVJPEG_CSS_422, NVJPEG_CSS_420, NVJPEG_CSS_440,
        NVJPEG_CSS_411}) {
    int h = 0, v = 0;
    if (Factors(ss, &h, &v) && h == hf && v == vf) return true;
  }
  return false;
}

// One launch on `stream`; a launch the runtime takes counts once in
// g_launches, here and nowhere else.
cudaError_t LaunchYccToRgb(const unsigned char* yp, const unsigned char* cbp,
                           const unsigned char* crp, int w, int h, int cw,
                           int ch, int hf, int vf, int coding,
                           unsigned char* out, cudaStream_t stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h);
  YccToRgb<<<grid, block, 0, stream>>>(yp, cbp, crp, w, h, cw, ch, hf, vf,
                                       coding, out);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) g_launches.fetch_add(1);
  return e;
}

// One worker's decoder: its own nvjpeg handle and state, its own
// non-blocking stream, a device buffer for the planar output and a
// pinned host buffer it is copied back into. Created on the worker's
// thread after cudaSetDevice; every call returns "" or the error text.
class Decoder {
 public:
  ~Decoder() {
    if (dbuf_) {
      cudaFreeAsync(dbuf_, stream_);
      cudaStreamSynchronize(stream_);
    }
    if (hbuf_) cudaFreeHost(hbuf_);
    if (state_) nvjpegJpegStateDestroy(state_);
    if (handle_) nvjpegDestroy(handle_);
    if (stream_) cudaStreamDestroy(stream_);
  }

  std::string Init(int device) {
    cudaError_t e = cudaSetDevice(device);
    if (e != cudaSuccess) return CudaMsg("cudaSetDevice", e);
    nvjpegStatus_t st = nvjpegCreateEx(NVJPEG_BACKEND_HYBRID, nullptr,
                                       nullptr, 0, &handle_);
    if (st != NVJPEG_STATUS_SUCCESS) return JpegMsg("nvjpegCreateEx", st);
    st = nvjpegJpegStateCreate(handle_, &state_);
    if (st != NVJPEG_STATUS_SUCCESS)
      return JpegMsg("nvjpegJpegStateCreate", st);
    e = cudaStreamCreateWithFlags(&stream_, cudaStreamNonBlocking);
    if (e != cudaSuccess) return CudaMsg("cudaStreamCreateWithFlags", e);
    return "";
  }

  // Decode one blob into `out` (CHW, out_mode 1 float32 / 2 uint8), or
  // leave it raw (c == 0). Returns "" unless the stream must fail.
  std::string Decode(std::vector<unsigned char> blob, int out_mode,
                     Decoded* out, bool* decoded) {
    *decoded = false;
    const bool jpeg = blob.size() >= 3 && blob[0] == 0xFF &&
                      blob[1] == 0xD8 && blob[2] == 0xFF;
    const int coding = jpeg ? Coding(blob) : kNoRgb;
    if (coding != kNoRgb) {
      int nc = 0;
      nvjpegChromaSubsampling_t ss = NVJPEG_CSS_UNKNOWN;
      int ws[NVJPEG_MAX_COMPONENT] = {0}, hs[NVJPEG_MAX_COMPONENT] = {0};
      nvjpegStatus_t st = nvjpegGetImageInfo(handle_, blob.data(),
                                             blob.size(), &nc, &ss, ws, hs);
      if (st != NVJPEG_STATUS_SUCCESS && !IsVerdict(st))
        return JpegMsg("nvjpegGetImageInfo", st);
      // (horizontal, vertical) chroma factors; none for grayscale
      int hf = 1, vf = 1;
      bool taken = st == NVJPEG_STATUS_SUCCESS && ws[0] > 0 && hs[0] > 0;
      if (coding == kGray)
        taken = taken && nc == 1 && ss == NVJPEG_CSS_GRAY;
      else
        taken = taken && nc == 3 && Factors(ss, &hf, &vf) &&
                ws[1] == (ws[0] + hf - 1) / hf &&
                hs[1] == (hs[0] + vf - 1) / vf && ws[2] == ws[1] &&
                hs[2] == hs[1];
      if (taken) {
        std::string err = DecodeRgb(blob, ws[0], hs[0], ws[1], hs[1], hf,
                                    vf, coding, decoded);
        if (!err.empty()) return err;
        if (*decoded) {
          ToOutput(ws[0], hs[0], out_mode, out);
          return "";
        }
      }
    }
    g_raw.fetch_add(1);
    out->raw = std::move(blob);
    out->h = 0;
    out->w = static_cast<int>(out->raw.size());
    out->c = 0;
    return "";
  }

 private:
  // Device room for the Y, Cb, Cr planes and the RGB planes; pinned host
  // room for the RGB planes. Both grow at least twofold, so a stream of
  // ever larger images reallocates a few times, not once an image; the
  // device buffer is stream-ordered (cudaMallocAsync / cudaFreeAsync on
  // the worker's stream), so growing it does not synchronise the card the
  // training step runs on, as cudaFree would.
  std::string Reserve(size_t dev, size_t host) {
    constexpr size_t kLeast = 1 << 20;
    if (dev > dcap_) {
      const size_t cap = std::max({dev, 2 * dcap_, kLeast});
      if (dbuf_) {
        cudaError_t e = cudaFreeAsync(dbuf_, stream_);
        if (e != cudaSuccess) return CudaMsg("cudaFreeAsync", e);
      }
      dbuf_ = nullptr;
      dcap_ = 0;
      cudaError_t e = cudaMallocAsync(reinterpret_cast<void**>(&dbuf_), cap,
                                      stream_);
      if (e != cudaSuccess) return CudaMsg("cudaMallocAsync", e);
      dcap_ = cap;
    }
    if (host > hcap_) {
      const size_t cap = std::max({host, 2 * hcap_, kLeast});
      if (hbuf_) cudaFreeHost(hbuf_);
      hbuf_ = nullptr;
      hcap_ = 0;
      cudaError_t e = cudaMallocHost(&hbuf_, cap);
      if (e != cudaSuccess) return CudaMsg("cudaMallocHost", e);
      hcap_ = cap;
    }
    return "";
  }

  // nvjpegDecode into planar Y, Cb, Cr or R, G, B as coded (w x h, then
  // cw x ch each) or a grayscale file's Y, the upsampling and colour
  // conversion kernel into CHW RGB, then one copy into the pinned buffer
  // on the worker's stream, which alone is synchronised.
  std::string DecodeRgb(const std::vector<unsigned char>& blob, int w, int h,
                        int cw, int ch, int hf, int vf, int coding,
                        bool* decoded) {
    const size_t plane = static_cast<size_t>(w) * h;
    const size_t cplane =
        coding == kGray ? 0 : static_cast<size_t>(cw) * ch;
    std::string err = Reserve(plane + 2 * cplane + 3 * plane, 3 * plane);
    if (!err.empty()) return err;
    unsigned char* yp = dbuf_;
    unsigned char* cbp = yp + plane;
    unsigned char* crp = cbp + cplane;
    unsigned char* rgb = crp + cplane;
    nvjpegImage_t img;
    std::memset(&img, 0, sizeof(img));
    img.channel[0] = yp;
    img.pitch[0] = static_cast<size_t>(w);
    if (coding != kGray) {
      img.channel[1] = cbp;
      img.pitch[1] = static_cast<size_t>(cw);
      img.channel[2] = crp;
      img.pitch[2] = static_cast<size_t>(cw);
    }
    const nvjpegOutputFormat_t fmt =
        coding == kGray ? NVJPEG_OUTPUT_Y
                        : coding == kRgb ? NVJPEG_OUTPUT_UNCHANGED
                                         : NVJPEG_OUTPUT_YUV;
    nvjpegStatus_t st = nvjpegDecode(handle_, state_, blob.data(),
                                     blob.size(), fmt, &img, stream_);
    if (IsVerdict(st)) return "";
    if (st != NVJPEG_STATUS_SUCCESS) return JpegMsg("nvjpegDecode", st);
    cudaError_t e = LaunchYccToRgb(yp, coding == kGray ? nullptr : cbp,
                                   coding == kGray ? nullptr : crp, w, h, cw,
                                   ch, hf, vf, coding, rgb, stream_);
    if (e != cudaSuccess) return CudaMsg("YccToRgb launch", e);
    e = cudaMemcpyAsync(hbuf_, rgb, 3 * plane, cudaMemcpyDeviceToHost,
                        stream_);
    if (e != cudaSuccess) return CudaMsg("cudaMemcpyAsync", e);
    e = cudaStreamSynchronize(stream_);
    if (e != cudaSuccess) return CudaMsg("cudaStreamSynchronize", e);
    *decoded = true;
    return "";
  }

  // the pinned CHW uint8 -> the record's own buffer (float32 for
  // out_mode 1, converted here on the worker thread as cxxnet_io.cc's
  // ToChw does)
  void ToOutput(int w, int h, int out_mode, Decoded* out) {
    const size_t n = 3 * static_cast<size_t>(w) * h;
    if (out_mode == 1) {
      out->chw.resize(n);
      for (size_t i = 0; i < n; ++i)
        out->chw[i] = static_cast<float>(hbuf_[i]);
    } else {
      out->chw_u8.assign(hbuf_, hbuf_ + n);
    }
    out->h = h;
    out->w = w;
    out->c = 3;
  }

  nvjpegHandle_t handle_ = nullptr;
  nvjpegJpegState_t state_ = nullptr;
  cudaStream_t stream_ = nullptr;
  unsigned char* dbuf_ = nullptr;
  unsigned char* hbuf_ = nullptr;
  size_t dcap_ = 0, hcap_ = 0;
};

struct Task {
  int64_t seq;
  std::vector<unsigned char> blob;
};

class Pipeline {
 public:
  Pipeline(std::vector<std::string> paths, int n_threads, int max_inflight,
           int out_mode, int device)
      : paths_(std::move(paths)),
        n_threads_(std::max(1, n_threads)),
        max_inflight_(std::max(2, max_inflight)),
        out_mode_(out_mode),
        device_(device) {}

  ~Pipeline() { Stop(); }

  void Start() {
    Stop();
    stop_.store(false);
    eof_ = false;
    next_seq_ = 0;
    consume_seq_ = 0;
    tasks_.clear();
    done_.clear();
    error_.clear();
    error_kind_ = 0;
    reader_ = std::thread(&Pipeline::ReaderMain, this);
    for (int i = 0; i < n_threads_; ++i)
      workers_.emplace_back(&Pipeline::WorkerMain, this);
  }

  void Stop() {
    {
      // the stop flag and the notifies are published under the mutex: a
      // waiter that has evaluated its predicate but not yet blocked would
      // otherwise miss the wakeup and hang the joins below
      std::lock_guard<std::mutex> lk(mu_);
      stop_.store(true);
      cv_task_.notify_all();
      cv_done_.notify_all();
      cv_space_.notify_all();
    }
    if (reader_.joinable()) reader_.join();
    for (auto& t : workers_)
      if (t.joinable()) t.join();
    workers_.clear();
  }

  // Pull the next record in stream order; false at end of stream or on
  // error (error() says which).
  bool Next(Decoded* out) {
    std::unique_lock<std::mutex> lk(mu_);
    cv_done_.wait(lk, [&] {
      return stop_.load() || !error_.empty() ||
             done_.count(consume_seq_) ||
             (eof_ && consume_seq_ >= next_seq_ && tasks_.empty() &&
              inflight_ == 0);
    });
    if (stop_.load() || !error_.empty()) return false;
    auto it = done_.find(consume_seq_);
    if (it == done_.end()) return false;  // clean EOF
    *out = std::move(it->second);
    done_.erase(it);
    ++consume_seq_;
    cv_space_.notify_one();
    return true;
  }

  std::string error(int* kind) {
    std::lock_guard<std::mutex> lk(mu_);
    *kind = error_kind_;
    return error_;
  }

 private:
  void Fail(int kind, const std::string& msg) {
    std::lock_guard<std::mutex> lk(mu_);
    if (error_.empty()) {
      error_ = msg;
      error_kind_ = kind;
    }
    cv_done_.notify_all();
    cv_task_.notify_all();
    cv_space_.notify_all();
  }

  void ReaderMain() {
    std::vector<unsigned char> page(kPageSize);
    for (const auto& path : paths_) {
      FILE* f = std::fopen(path.c_str(), "rb");
      if (!f) {
        Fail(kErrIO, "cannot open " + path);
        return;
      }
      while (!stop_.load()) {
        size_t got = std::fread(page.data(), 1, kPageSize, f);
        if (got == 0) break;
        if (got < static_cast<size_t>(kPageSize)) {
          std::fclose(f);
          Fail(kErrIO, "truncated page in " + path);
          return;
        }
        const int32_t* ints = reinterpret_cast<const int32_t*>(page.data());
        int32_t n = ints[0];
        if (n < 0 ||
            static_cast<int64_t>(n) + 2 > static_cast<int64_t>(kPageNumInts)) {
          std::fclose(f);
          Fail(kErrIO, "corrupt page header in " + path);
          return;
        }
        for (int32_t r = 0; r < n && !stop_.load(); ++r) {
          int64_t start = ints[r + 1], end = ints[r + 2];
          if (start < 0 || end < start || end > kPageSize) {
            std::fclose(f);
            Fail(kErrIO, "corrupt blob offsets in " + path);
            return;
          }
          std::vector<unsigned char> blob(
              page.data() + kPageSize - end, page.data() + kPageSize - start);
          std::unique_lock<std::mutex> lk(mu_);
          cv_space_.wait(lk, [&] {
            return stop_.load() || !error_.empty() ||
                   static_cast<int>(tasks_.size() + done_.size()) +
                           inflight_ < max_inflight_;
          });
          if (stop_.load() || !error_.empty()) {
            lk.unlock();
            std::fclose(f);
            return;
          }
          tasks_.push_back(Task{next_seq_++, std::move(blob)});
          cv_task_.notify_one();
        }
      }
      std::fclose(f);
    }
    std::lock_guard<std::mutex> lk(mu_);
    eof_ = true;
    cv_task_.notify_all();
    cv_done_.notify_all();
  }

  void WorkerMain() {
    Decoder dec;
    std::string err = dec.Init(device_);
    if (!err.empty()) {
      Fail(kErrDevice, err);
      return;
    }
    while (true) {
      Task task;
      {
        std::unique_lock<std::mutex> lk(mu_);
        cv_task_.wait(lk, [&] {
          return stop_.load() || !error_.empty() || !tasks_.empty() || eof_;
        });
        if (stop_.load() || !error_.empty()) return;
        if (tasks_.empty()) {
          if (eof_) return;
          continue;
        }
        task = std::move(tasks_.front());
        tasks_.pop_front();
        ++inflight_;
      }
      Decoded d;
      bool decoded = false;
      err = dec.Decode(std::move(task.blob), out_mode_, &d, &decoded);
      if (!err.empty()) {
        Fail(kErrDevice, err);
        return;
      }
      {
        std::lock_guard<std::mutex> lk(mu_);
        done_.emplace(task.seq, std::move(d));
        --inflight_;
        cv_done_.notify_all();
      }
    }
  }

  std::vector<std::string> paths_;
  int n_threads_;
  int max_inflight_;
  int out_mode_;
  int device_;

  std::thread reader_;
  std::vector<std::thread> workers_;
  std::atomic<bool> stop_{true};

  std::mutex mu_;
  std::condition_variable cv_task_, cv_done_, cv_space_;
  std::deque<Task> tasks_;
  std::map<int64_t, Decoded> done_;
  int inflight_ = 0;
  int64_t next_seq_ = 0;
  int64_t consume_seq_ = 0;
  bool eof_ = false;
  std::string error_;
  int error_kind_ = 0;
};

struct Handle {
  std::unique_ptr<Pipeline> pipe;
  Decoded current;  // owns the buffer returned by cxio_next
  std::string last_error;
  int last_error_kind = 0;
  std::vector<std::string> paths;
  int n_threads = 4;
  int max_inflight = 64;
  int out_mode = 1;
  int device = 0;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

typedef struct {
  const unsigned char* data;  // CHW f32 / u8 per out_mode, or the raw blob
  int h, w, c;                // c == 0: blob handed back, byte length in w
} CxioRecord;

// out_mode 1: records come back as CHW float32 (the DataInst layout);
// out_mode 2: CHW uint8 (device_augment staging). Any other mode, or a
// negative device ordinal, is refused (NULL).
void* cxio_open(const char* const* bin_paths, int n_bins, int n_threads,
                int max_inflight, int out_mode, int device) {
  if ((out_mode != 1 && out_mode != 2) || device < 0) return nullptr;
  auto* h = new Handle();
  for (int i = 0; i < n_bins; ++i) h->paths.emplace_back(bin_paths[i]);
  if (n_threads > 0) h->n_threads = n_threads;
  if (max_inflight > 0) h->max_inflight = max_inflight;
  h->out_mode = out_mode;
  h->device = device;
  return h;
}

void cxio_before_first(void* handle) {
  auto* h = static_cast<Handle*>(handle);
  h->pipe.reset();  // joins the previous pass's threads first
  h->pipe.reset(new Pipeline(h->paths, h->n_threads, h->max_inflight,
                             h->out_mode, h->device));
  h->pipe->Start();
}

int cxio_next(void* handle, CxioRecord* rec) {
  auto* h = static_cast<Handle*>(handle);
  if (!h->pipe) cxio_before_first(handle);
  if (!h->pipe->Next(&h->current)) {
    h->last_error = h->pipe->error(&h->last_error_kind);
    return 0;
  }
  if (h->current.c == 0) {
    rec->data = h->current.raw.data();
  } else if (h->out_mode == 1) {
    rec->data = reinterpret_cast<const unsigned char*>(
        h->current.chw.data());
  } else {
    rec->data = h->current.chw_u8.data();
  }
  rec->h = h->current.h;
  rec->w = h->current.w;
  rec->c = h->current.c;
  return 1;
}

const char* cxio_last_error(void* handle) {
  return static_cast<Handle*>(handle)->last_error.c_str();
}

// 0 none, 1 the files (missing, truncated, corrupt), 2 a CUDA / nvJPEG
// error
int cxio_error_kind(void* handle) {
  return static_cast<Handle*>(handle)->last_error_kind;
}

// The process's counts since the last cxio_reset_counters: out[0]
// YccToRgb launches (one an image a worker decoded, one a
// cxio_ycc_to_rgb call), out[1] blobs the workers handed back raw.
void cxio_counters(long long* out) {
  out[0] = g_launches.load();
  out[1] = g_raw.load();
}

void cxio_reset_counters(void) {
  g_launches.store(0);
  g_raw.store(0);
}

const char* cxio_backend(void) {
  return "NVJPEG_BACKEND_HYBRID through nvjpegDecode, one image a call: "
         "Huffman decode on the worker's CPU thread, IDCT on the card "
         "into the file's planes (NVJPEG_OUTPUT_YUV, _UNCHANGED for R, G, "
         "B files, _Y for grayscale), then YccToRgb (libjpeg's upsampling "
         "and YCbCr tables) on the worker's own non-blocking stream";
}

// nvJPEG's version: out[0..2] = major, minor, patch; returns the status
int cxio_version(int* out) {
  nvjpegStatus_t st = nvjpegGetProperty(MAJOR_VERSION, &out[0]);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegGetProperty(MINOR_VERSION, &out[1]);
  if (st == NVJPEG_STATUS_SUCCESS)
    st = nvjpegGetProperty(PATCH_LEVEL, &out[2]);
  return static_cast<int>(st);
}

// The card's hardware JPEG decoder as nvJPEG reports it: out[0] engines,
// out[1] cores per engine. Returns the status of creating a
// NVJPEG_BACKEND_HARDWARE handle (non-zero where the card has none, e.g.
// NVJPEG_STATUS_ARCH_MISMATCH) or of nvjpegGetHardwareDecoderInfo; -1
// when cudaSetDevice fails. The decoder itself does not use this backend.
int cxio_hw_info(int device, unsigned int* out) {
  out[0] = out[1] = 0;
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  nvjpegHandle_t handle = nullptr;
  nvjpegStatus_t st = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr,
                                     nullptr, 0, &handle);
  if (st != NVJPEG_STATUS_SUCCESS) return static_cast<int>(st);
  st = nvjpegGetHardwareDecoderInfo(handle, &out[0], &out[1]);
  nvjpegDestroy(handle);
  return static_cast<int>(st);
}

void cxio_close(void* handle) { delete static_cast<Handle*>(handle); }

// YccToRgb alone on device planes (uint8): Y (h x w), Cb and Cr (ch x cw,
// the factors' subsampled sizes; both null for `coding` 2, grayscale) ->
// out (3 x h x w), launched on `stream` without synchronising; `coding` 0
// is Y, Cb, Cr, 1 R, G, B. Returns cudaGetLastError() after the launch
// (counted when it is 0), or cudaErrorInvalidValue for what it does not
// take.
int cxio_ycc_to_rgb(const void* y, const void* cb, const void* cr, int w,
                    int h, int cw, int ch, int hf, int vf, int coding,
                    void* out, void* stream) {
  const bool gray = coding == kGray;
  if ((coding != kYcc && coding != kRgb && !gray) || w <= 0 || h <= 0 ||
      h > 65535 || gray != (cb == nullptr) || gray != (cr == nullptr) ||
      (!gray && (!FactorsTaken(hf, vf) || cw != (w + hf - 1) / hf ||
                 ch != (h + vf - 1) / vf)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(LaunchYccToRgb(
      static_cast<const unsigned char*>(y),
      static_cast<const unsigned char*>(cb),
      static_cast<const unsigned char*>(cr), w, h, cw, ch, hf, vf, coding,
      static_cast<unsigned char*>(out), static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
