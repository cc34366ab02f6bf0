// avimux — streaming RIFF/AVI muxer (C ABI, loaded via ctypes).
//
// The replacement for the reference's only native component: the
// Win32 avifil32.dll P/Invoke layer (aviFileWrapper_src/Avi.cs:175-389,
// AviManager.cs:33-54, VideoStream.cs:344-365).  Unlike the pure-Python
// writer in raytpu/io/avi.py (which buffers every frame and assembles the
// container at close), this muxer STREAMS: headers are written up front
// with placeholder sizes, each add_frame goes straight to disk (converting
// RGB rows to the container's bottom-up BGR in C++ for the "DIB " codec, or
// passing pre-encoded JPEG bytes through for "MJPG"), and close() seeks
// back to patch the sizes and append the idx1 index — constant memory for
// arbitrarily long animations, matching AVIStreamWrite's streaming
// semantics.
//
// Build: make -C native   (g++ -O2 -shared -fPIC avimux.cc -o libavimux.so)

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct IndexEntry {
  uint32_t offset;  // relative to start of 'movi' list body
  uint32_t size;
};

struct AviMux {
  FILE* f = nullptr;
  int width = 0;
  int height = 0;
  double fps = 30.0;
  bool uncompressed = true;  // "DIB " vs "MJPG"
  long avih_pos = 0;
  long strh_pos = 0;
  long strf_pos = 0;
  long movi_size_pos = 0;
  long movi_start = 0;
  long riff_size_pos = 0;
  uint32_t max_frame = 0;
  std::vector<IndexEntry> index;
  std::vector<uint8_t> rowbuf;
};

void put_u32(FILE* f, uint32_t v) { fwrite(&v, 4, 1, f); }
void put_u16(FILE* f, uint16_t v) { fwrite(&v, 2, 1, f); }
void put_i32(FILE* f, int32_t v) { fwrite(&v, 4, 1, f); }
void put_cc(FILE* f, const char* cc) { fwrite(cc, 4, 1, f); }

uint32_t cc_val(const char* cc) {
  uint32_t v;
  std::memcpy(&v, cc, 4);
  return v;
}

// Header layout mirrors raytpu/io/avi.py::AviWriter.close (itself the
// MainAVIHeader / AVISTREAMINFO / BITMAPINFOHEADER triple of
// Avi.cs:120-139, :76-96, :50-62).  Fields that depend on the frame count
// or max frame size are zero here and patched in avimux_close.
void write_headers(AviMux* m) {
  FILE* f = m->f;
  put_cc(f, "RIFF");
  m->riff_size_pos = ftell(f);
  put_u32(f, 0);
  put_cc(f, "AVI ");

  // LIST hdrl
  const uint32_t avih_sz = 14 * 4;
  // 4s4sIHHIIIIIIII4i (python writer's AVISTREAMINFO packing) = 64 bytes.
  const uint32_t strh_sz = 64;
  const uint32_t strf_sz = 40;
  const uint32_t strl_sz = 4 + (8 + strh_sz) + (8 + strf_sz);
  const uint32_t hdrl_sz = 4 + (8 + avih_sz) + (8 + strl_sz);
  put_cc(f, "LIST");
  put_u32(f, hdrl_sz);
  put_cc(f, "hdrl");

  put_cc(f, "avih");
  put_u32(f, avih_sz);
  m->avih_pos = ftell(f);
  put_u32(f, (uint32_t)(1000000.0 / m->fps));  // dwMicroSecPerFrame
  put_u32(f, 0);                               // dwMaxBytesPerSec (patched)
  put_u32(f, 0);                               // dwPaddingGranularity
  put_u32(f, 0x10);                            // AVIF_HASINDEX
  put_u32(f, 0);                               // dwTotalFrames (patched)
  put_u32(f, 0);                               // dwInitialFrames
  put_u32(f, 1);                               // dwStreams
  put_u32(f, 0);                               // dwSuggestedBufferSize (patched)
  put_u32(f, (uint32_t)m->width);
  put_u32(f, (uint32_t)m->height);
  put_u32(f, 0); put_u32(f, 0); put_u32(f, 0); put_u32(f, 0);

  put_cc(f, "LIST");
  put_u32(f, strl_sz);
  put_cc(f, "strl");

  put_cc(f, "strh");
  put_u32(f, strh_sz);
  m->strh_pos = ftell(f);
  put_cc(f, "vids");
  put_cc(f, m->uncompressed ? "DIB " : "MJPG");
  put_u32(f, 0); put_u16(f, 0); put_u16(f, 0);
  put_u32(f, 0);
  put_u32(f, 1000);                                  // dwScale
  put_u32(f, (uint32_t)(m->fps * 1000.0 + 0.5));     // dwRate
  put_u32(f, 0);
  put_u32(f, 0);                                     // dwLength (patched)
  put_u32(f, 0);                                     // dwSuggestedBufferSize (patched)
  put_u32(f, 0xFFFFFFFFu);                           // dwQuality
  put_u32(f, 0);
  // rcFrame (4 x int16 in avifil32; python writer uses 4 x int32 — match it)
  put_i32(f, 0); put_i32(f, 0);
  put_i32(f, m->width); put_i32(f, m->height);

  put_cc(f, "strf");
  put_u32(f, strf_sz);
  m->strf_pos = ftell(f);
  put_u32(f, 40);                   // biSize
  put_i32(f, m->width);
  put_i32(f, m->height);
  put_u16(f, 1);                    // biPlanes
  put_u16(f, 24);                   // biBitCount
  put_u32(f, m->uncompressed ? 0 : cc_val("MJPG"));
  put_u32(f, 0);                    // biSizeImage (patched)
  put_i32(f, 0); put_i32(f, 0);
  put_u32(f, 0); put_u32(f, 0);

  put_cc(f, "LIST");
  m->movi_size_pos = ftell(f);
  put_u32(f, 0);                    // movi size (patched)
  put_cc(f, "movi");
  m->movi_start = ftell(f);
}

}  // namespace

extern "C" {

// Open a new AVI for streaming.  codec: 0 = "DIB " (pass raw RGB rows to
// add_frame), 1 = "MJPG" (pass encoded JPEG bytes).  Returns NULL on error.
void* avimux_open(const char* path, int width, int height, double fps,
                  int codec) {
  if (width <= 0 || height <= 0 || fps <= 0.0) return nullptr;
  FILE* f = std::fopen(path, "wb");
  if (!f) return nullptr;
  AviMux* m = new AviMux;
  m->f = f;
  m->width = width;
  m->height = height;
  m->fps = fps;
  m->uncompressed = (codec == 0);
  write_headers(m);
  return m;
}

// DIB path: rgb is (height, width, 3) row-major top-down RGB; converted to
// the container's bottom-up BGR with 4-byte row padding (what
// VideoStream.AddFrame's locked bitmap handed to AVIStreamWrite).
int avimux_add_frame_rgb(void* handle, const uint8_t* rgb) {
  AviMux* m = static_cast<AviMux*>(handle);
  if (!m || !m->uncompressed) return -1;
  const int w = m->width, h = m->height;
  const uint32_t stride = (uint32_t)((w * 3 + 3) & ~3);
  const uint32_t size = stride * (uint32_t)h;

  long chunk_off = ftell(m->f) - m->movi_start;
  put_cc(m->f, "00db");
  put_u32(m->f, size);
  m->rowbuf.resize(stride);
  std::memset(m->rowbuf.data(), 0, stride);
  for (int y = h - 1; y >= 0; --y) {
    const uint8_t* src = rgb + (size_t)y * w * 3;
    uint8_t* dst = m->rowbuf.data();
    for (int x = 0; x < w; ++x) {
      dst[x * 3 + 0] = src[x * 3 + 2];
      dst[x * 3 + 1] = src[x * 3 + 1];
      dst[x * 3 + 2] = src[x * 3 + 0];
    }
    if (fwrite(m->rowbuf.data(), 1, stride, m->f) != stride) return -2;
  }
  if (size % 2) fputc(0, m->f);
  m->index.push_back({(uint32_t)(chunk_off + 4), size});
  if (size > m->max_frame) m->max_frame = size;
  return 0;
}

// MJPG path: data is a complete JPEG for one frame.
int avimux_add_frame_jpeg(void* handle, const uint8_t* data, uint32_t len) {
  AviMux* m = static_cast<AviMux*>(handle);
  if (!m || m->uncompressed) return -1;
  long chunk_off = ftell(m->f) - m->movi_start;
  put_cc(m->f, "00dc");
  put_u32(m->f, len);
  if (fwrite(data, 1, len, m->f) != len) return -2;
  if (len % 2) fputc(0, m->f);
  m->index.push_back({(uint32_t)(chunk_off + 4), len});
  if (len > m->max_frame) m->max_frame = len;
  return 0;
}

int avimux_frame_count(void* handle) {
  AviMux* m = static_cast<AviMux*>(handle);
  return m ? (int)m->index.size() : -1;
}

// Patch sizes, append idx1, close the file.  Returns 0 on success.
int avimux_close(void* handle) {
  AviMux* m = static_cast<AviMux*>(handle);
  if (!m) return -1;
  FILE* f = m->f;
  const uint32_t n = (uint32_t)m->index.size();
  const char* cc = m->uncompressed ? "00db" : "00dc";

  long movi_end = ftell(f);
  // idx1: AVIOLDINDEX entries (ckid, dwFlags=AVIIF_KEYFRAME, offset, size).
  put_cc(f, "idx1");
  put_u32(f, n * 16);
  for (const IndexEntry& e : m->index) {
    put_cc(f, cc);
    put_u32(f, 0x10);
    put_u32(f, e.offset);
    put_u32(f, e.size);
  }
  long file_end = ftell(f);

  fseek(f, m->riff_size_pos, SEEK_SET);
  put_u32(f, (uint32_t)(file_end - m->riff_size_pos - 4));

  fseek(f, m->avih_pos + 4, SEEK_SET);
  put_u32(f, (uint32_t)(m->max_frame * m->fps));  // dwMaxBytesPerSec
  fseek(f, m->avih_pos + 16, SEEK_SET);
  put_u32(f, n);  // dwTotalFrames
  fseek(f, m->avih_pos + 28, SEEK_SET);
  put_u32(f, m->max_frame);  // dwSuggestedBufferSize

  fseek(f, m->strh_pos + 32, SEEK_SET);
  put_u32(f, n);             // dwLength
  put_u32(f, m->max_frame);  // dwSuggestedBufferSize

  fseek(f, m->strf_pos + 20, SEEK_SET);
  put_u32(f, m->max_frame);  // biSizeImage

  fseek(f, m->movi_size_pos, SEEK_SET);
  put_u32(f, (uint32_t)(movi_end - m->movi_size_pos - 4));

  int rc = fclose(f) == 0 ? 0 : -2;
  delete m;
  return rc;
}

// Abort without patching (file is left truncated/invalid).
void avimux_abort(void* handle) {
  AviMux* m = static_cast<AviMux*>(handle);
  if (!m) return;
  fclose(m->f);
  delete m;
}

}  // extern "C"
