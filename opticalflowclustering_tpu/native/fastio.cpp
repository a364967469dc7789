// Native host-IO runtime: threaded batch PNG decode and MJPEG-AVI
// demux/decode straight into one preallocated uint8 batch buffer.
//
// This is the framework's C++ data-loader layer — the counterpart of the native decode the reference gets implicitly from
// OpenCV's C++ core (`cv2.imread` per cell PNG in
// `k-means-color-clustering/color_kmeansChange.py:147-159`, `cv2.
// VideoCapture` in `KmeanGrids.py:156`). The Python boundary stays thin:
// io/fastio.py passes file paths and one numpy buffer; every per-file
// cost (open/parse/decode/color-convert) runs here, fanned out over a
// std::thread pool, and frames land in batch layout [N, H, W, 3] BGR —
// the exact array the device upload wants, no per-frame Python objects.
//
// Build: io/fastio.py compiles this with g++ -O3 -shared -fPIC
//   -ljpeg -lpng at first use and caches the .so next to this file.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>
#include <png.h>

#include <sys/stat.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <map>
#include <mutex>
#include <string>
#include <thread>
#include <utility>
#include <vector>

namespace {

constexpr int kOk = 0;
constexpr int kErrOpen = -1;
constexpr int kErrFormat = -2;
constexpr int kErrShape = -3;

// ---------------------------------------------------------------- PNG ----

struct PngReadCtx {
  const uint8_t* data;
  size_t size;
  size_t pos;
};

void png_mem_read(png_structp png, png_bytep out, png_size_t n) {
  PngReadCtx* ctx = static_cast<PngReadCtx*>(png_get_io_ptr(png));
  if (ctx->pos + n > ctx->size) {
    png_error(png, "eof");
  }
  std::memcpy(out, ctx->data + ctx->pos, n);
  ctx->pos += n;
}

bool read_file(const char* path, std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long n = std::ftell(f);
  std::fseek(f, 0, SEEK_SET);
  out->resize(n > 0 ? static_cast<size_t>(n) : 0);
  bool ok = n >= 0 &&
            std::fread(out->data(), 1, out->size(), f) == out->size();
  std::fclose(f);
  return ok;
}

// Decode one PNG to BGR at [h, w, 3] into `out`; returns kOk or an error.
int decode_png_one(const uint8_t* bytes, size_t size, uint8_t* out, int h,
                   int w) {
  if (size < 8 || png_sig_cmp(bytes, 0, 8)) return kErrFormat;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return kErrFormat;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return kErrFormat;
  }
  std::vector<uint8_t*> rows;
  std::vector<uint8_t> rgb;
  PngReadCtx ctx{bytes, size, 0};
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrFormat;
  }
  png_set_read_fn(png, &ctx, png_mem_read);
  png_read_info(png, info);
  png_uint_32 iw = png_get_image_width(png, info);
  png_uint_32 ih = png_get_image_height(png, info);
  if (static_cast<int>(iw) != w || static_cast<int>(ih) != h) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrShape;
  }
  int depth = png_get_bit_depth(png, info);
  int color = png_get_color_type(png, info);
  // normalize every layout to 8-bit BGR
  if (depth == 16) png_set_strip_16(png);
  if (color == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color == PNG_COLOR_TYPE_GRAY && depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color == PNG_COLOR_TYPE_GRAY || color == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_bgr(png);
  png_read_update_info(png, info);
  size_t stride = png_get_rowbytes(png, info);
  if (stride != static_cast<size_t>(w) * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return kErrFormat;
  }
  rows.resize(h);
  for (int r = 0; r < h; ++r) rows[r] = out + static_cast<size_t>(r) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  return kOk;
}

// --------------------------------------------------------------- JPEG ----

struct JpegErr {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void jpeg_err_exit(j_common_ptr cinfo) {
  JpegErr* err = reinterpret_cast<JpegErr*>(cinfo->err);
  longjmp(err->jump, 1);
}

int decode_jpeg_one(const uint8_t* bytes, size_t size, uint8_t* out, int h,
                    int w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return kErrFormat;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes, size);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_EXT_BGR;  // libjpeg-turbo: BGR straight out
  // match cv2's decoder configuration so frames are bit-identical to the
  // cv2.VideoCapture path (OpenCV disables fancy chroma upsampling).
  cinfo.do_fancy_upsampling = FALSE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_width) != w ||
      static_cast<int>(cinfo.output_height) != h ||
      cinfo.output_components != 3) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return kErrShape;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row =
        out + static_cast<size_t>(cinfo.output_scanline) * w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return kOk;
}

bool jpeg_probe(const uint8_t* bytes, size_t size, int* h, int* w) {
  jpeg_decompress_struct cinfo;
  JpegErr jerr;
  cinfo.err = jpeg_std_error(&jerr.mgr);
  jerr.mgr.error_exit = jpeg_err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, bytes, size);
  jpeg_read_header(&cinfo, TRUE);
  *h = cinfo.image_height;
  *w = cinfo.image_width;
  jpeg_abort_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return true;
}

// ----------------------------------------------------------- AVI RIFF ----

uint32_t rd32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

bool tag_is(const uint8_t* p, const char* t) {
  return std::memcmp(p, t, 4) == 0;
}

// Seek-based index pass: walk the RIFF tree reading only box/chunk
// HEADERS (8–12 bytes each) and fseek past payloads — O(n_frames) memory
// regardless of file size, one sequential metadata sweep of the disk.
// Accepts the '00dc'/'00db' video chunks of the movi LIST (the container
// cv2.VideoWriter MJPG produces). Files larger than ~1 GB are OpenDML:
// the writer appends extension `RIFF....AVIX` segments after the primary
// `RIFF....AVI ` one, each with its own movi LIST — the outer loop walks
// ALL segments so long clips index completely instead of silently
// truncating at the first segment's frames.
bool index_avi_file(const char* path,
                    std::vector<std::pair<size_t, size_t>>* chunks) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long fsize = std::ftell(f);
  long rpos = 0;
  bool first = true;
  while (rpos + 12 <= fsize) {
    uint8_t hdr[12];
    std::fseek(f, rpos, SEEK_SET);
    if (std::fread(hdr, 1, 12, f) != 12 || !tag_is(hdr, "RIFF")) break;
    bool form_ok = first ? tag_is(hdr + 8, "AVI ")
                         : (tag_is(hdr + 8, "AVIX") || tag_is(hdr + 8, "AVI "));
    if (!form_ok) break;
    first = false;
    uint32_t rsz = rd32(hdr + 4);
    long rend = rpos + 8 + static_cast<long>(rsz);
    if (rend > fsize) rend = fsize;
    long pos = rpos + 12;
    while (pos + 8 <= rend) {
      uint8_t bh[12];
      std::fseek(f, pos, SEEK_SET);
      size_t got = std::fread(bh, 1, 12, f);
      if (got < 8) break;
      uint32_t sz = rd32(bh + 4);
      if (tag_is(bh, "LIST") && got == 12) {
        if (tag_is(bh + 8, "movi")) {
          long mp = pos + 12;
          long mend = pos + 8 + static_cast<long>(sz);
          if (mend > rend) mend = rend;
          while (mp + 8 <= mend) {
            uint8_t ch[8];
            std::fseek(f, mp, SEEK_SET);
            if (std::fread(ch, 1, 8, f) != 8) break;
            uint32_t csz = rd32(ch + 4);
            if ((ch[2] == 'd' && (ch[3] == 'c' || ch[3] == 'b')) &&
                mp + 8 + static_cast<long>(csz) <= fsize) {
              chunks->emplace_back(static_cast<size_t>(mp + 8),
                                   static_cast<size_t>(csz));
            }
            mp += 8 + static_cast<long>(csz) + (csz & 1);
          }
          break;  // one movi per RIFF segment; go to the next segment
        }
        pos += 12;  // descend into other LISTs (hdrl etc.)
        continue;
      }
      pos += 8 + static_cast<long>(sz) + (sz & 1);
    }
    rpos = rend + (rsz & 1);
  }
  std::fclose(f);
  return !chunks->empty();
}

// Per-path chunk-index cache (validated by mtime+size) so streaming
// consumers don't re-parse the container per probe/segment. Entries are
// copied out under the lock — a concurrent refresh can't invalidate a
// reader's view.
struct AviIndex {
  int64_t mtime;
  int64_t fsize;
  std::vector<std::pair<size_t, size_t>> chunks;
};
std::mutex g_avi_mu;
std::map<std::string, AviIndex>& avi_cache() {
  static std::map<std::string, AviIndex>* m = new std::map<std::string, AviIndex>();
  return *m;
}

bool avi_index_cached(const char* path,
                      std::vector<std::pair<size_t, size_t>>* chunks) {
  struct stat st;
  if (::stat(path, &st) != 0) return false;
  {
    std::lock_guard<std::mutex> lk(g_avi_mu);
    auto it = avi_cache().find(path);
    if (it != avi_cache().end() &&
        it->second.mtime == static_cast<int64_t>(st.st_mtim.tv_sec) *
                                1000000000 +
                            st.st_mtim.tv_nsec &&
        it->second.fsize == static_cast<int64_t>(st.st_size)) {
      *chunks = it->second.chunks;
      return true;
    }
  }
  std::vector<std::pair<size_t, size_t>> fresh;
  if (!index_avi_file(path, &fresh)) return false;
  {
    std::lock_guard<std::mutex> lk(g_avi_mu);
    avi_cache()[path] =
        AviIndex{static_cast<int64_t>(st.st_mtim.tv_sec) * 1000000000 +
                     st.st_mtim.tv_nsec,
                 static_cast<int64_t>(st.st_size), fresh};
  }
  *chunks = std::move(fresh);
  return true;
}

// Read file bytes [lo, hi) — the working set of one decode window.
bool read_span(const char* path, size_t lo, size_t hi,
               std::vector<uint8_t>* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  out->resize(hi - lo);
  bool ok = std::fseek(f, static_cast<long>(lo), SEEK_SET) == 0 &&
            std::fread(out->data(), 1, out->size(), f) == out->size();
  std::fclose(f);
  return ok;
}

template <typename Fn>
void parallel_for(int n, int threads, Fn fn) {
  if (threads <= 1 || n <= 1) {
    for (int i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int> next{0};
  auto worker = [&] {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) fn(i);
  };
  std::vector<std::thread> pool;
  int nt = threads < n ? threads : n;
  pool.reserve(nt);
  for (int t = 0; t < nt; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
}

}  // namespace

extern "C" {

// Decode n same-size PNGs into out[n, h, w, 3] BGR. Returns 0 or the
// (negative) error code of the first failing file; `errs[i]` gets each
// file's status when errs != nullptr.
int ofc_decode_png_batch(const char** paths, int n, uint8_t* out, int h,
                         int w, int threads, int* errs) {
  std::atomic<int> rc{kOk};
  parallel_for(n, threads, [&](int i) {
    std::vector<uint8_t> bytes;
    int st = kErrOpen;
    if (read_file(paths[i], &bytes)) {
      st = decode_png_one(bytes.data(), bytes.size(),
                          out + static_cast<size_t>(i) * h * w * 3, h, w);
    }
    if (errs) errs[i] = st;
    int expect = kOk;
    if (st != kOk) rc.compare_exchange_strong(expect, st);
  });
  return rc.load();
}

// Probe an MJPEG AVI: frame count and dimensions (from the first frame).
// Uses the cached seek-based index + a first-chunk span read — O(n_frames)
// memory, never the whole file.
int ofc_mjpeg_avi_probe(const char* path, int* n, int* h, int* w) {
  std::vector<std::pair<size_t, size_t>> chunks;
  if (!avi_index_cached(path, &chunks)) return kErrFormat;
  std::vector<uint8_t> first;
  if (!read_span(path, chunks[0].first, chunks[0].first + chunks[0].second,
                 &first))
    return kErrOpen;
  if (!jpeg_probe(first.data(), first.size(), h, w)) return kErrFormat;
  *n = static_cast<int>(chunks.size());
  return kOk;
}

// Decode up to max_frames of an MJPEG AVI into out[n, h, w, 3] BGR.
// Returns the number of frames decoded, or a negative error code.
int ofc_mjpeg_avi_decode_flags(const char* path, uint8_t* out, int start,
                               int count, int h, int w, int threads,
                               uint8_t* done);

int ofc_mjpeg_avi_decode(const char* path, uint8_t* out, int max_frames,
                         int h, int w, int threads) {
  return ofc_mjpeg_avi_decode_flags(path, out, 0, max_frames, h, w, threads,
                                    nullptr);
}

// Streaming decode: like ofc_mjpeg_avi_decode but (a) starts at frame
// `start` of the container, and (b) publishes per-frame completion into
// `done[count]` (0→1, release-ordered AFTER the frame's pixels land), so a
// consumer thread can pipeline device work over the contiguous done-prefix
// while later frames still decode. Returns frames decoded or a negative
// error code.
int ofc_mjpeg_avi_decode_flags(const char* path, uint8_t* out, int start,
                               int count, int h, int w, int threads,
                               uint8_t* done) {
  std::vector<std::pair<size_t, size_t>> chunks;
  if (!avi_index_cached(path, &chunks)) return kErrFormat;
  int total = static_cast<int>(chunks.size());
  if (start < 0 || start >= total) return kErrShape;
  int n = total - start;
  if (count > 0 && count < n) n = count;
  // Read only this window's byte span — memory is O(segment bytes), not
  // O(file); the cached index means no per-window container re-parse.
  size_t lo = chunks[start].first;
  size_t hi = lo;
  for (int i = 0; i < n; ++i) {
    size_t c0 = chunks[start + i].first;
    size_t c1 = c0 + chunks[start + i].second;
    if (c0 < lo) lo = c0;
    if (c1 > hi) hi = c1;
  }
  std::vector<uint8_t> buf;
  if (!read_span(path, lo, hi, &buf)) return kErrOpen;
  std::atomic<int> rc{kOk};
  parallel_for(n, threads, [&](int i) {
    int st = decode_jpeg_one(buf.data() + (chunks[start + i].first - lo),
                             chunks[start + i].second,
                             out + static_cast<size_t>(i) * h * w * 3, h, w);
    int expect = kOk;
    if (st != kOk) rc.compare_exchange_strong(expect, st);
    // Publish completion only for GOOD frames: a failed frame's flag
    // stays 0, so the consumer's contiguous done-prefix stalls exactly
    // at the bad frame and check_rc() raises there (instead of streaming
    // garbage pixels into the device and failing later at the segment
    // join).
    if (done && st == kOk) {
      // release: the flag must not become visible before the pixels
      std::atomic_thread_fence(std::memory_order_release);
      reinterpret_cast<std::atomic<uint8_t>*>(done)[i].store(
          1, std::memory_order_relaxed);
    }
  });
  return rc.load() == kOk ? n : rc.load();
}

// Acquire side of the done-flag handshake above: the Python consumer reads
// `done` with plain numpy loads, which pair with the producer's release
// fence on x86 (loads are not reordered) but NOT on weakly-ordered CPUs
// (aarch64) — the consumer must call this after observing new flags and
// before touching the corresponding pixels, or it can read stale bytes.
void ofc_acquire_fence() {
  std::atomic_thread_fence(std::memory_order_acquire);
}

}  // extern "C"
