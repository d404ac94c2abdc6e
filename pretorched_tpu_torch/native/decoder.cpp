// Threaded JPEG decoding for the host side of the input pipeline.
//
// The reference's data path decodes JPEGs one-at-a-time through PIL inside
// DataLoader workers (examples/imagenet_eval.py:118-127). Here a C++ thread
// pool drives libjpeg directly so a single Python process can keep a TPU fed:
// the device-side resize/crop/normalize is fused in transforms/fused.py, and
// this library supplies decoded uint8 batches without the Python object
// overhead.
//
// C ABI (ctypes-friendly), see datasets/native.py for the Python wrapper.

#include <cstddef>
#include <cstdio>

#include <jpeglib.h>

#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->setjmp_buffer, 1);
}

// Decode one JPEG buffer to RGB. `scale_denom` in {1,2,4,8} uses libjpeg's
// DCT scaling to decode directly at reduced resolution (cheap downscale for
// preprocessing). Returns 0 on success.
int decode_one(const uint8_t* buf, size_t len, uint8_t* out, int out_h,
               int out_w, int scale_denom) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w) {
    jpeg_destroy_decompress(&cinfo);
    return 2;  // caller's dims are stale
  }
  const int stride = out_w * 3;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * stride;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // namespace

extern "C" {

// Header probe: output dims at the given DCT scale. Returns 0 on success.
int pt_jpeg_dims(const uint8_t* buf, size_t len, int scale_denom, int* h,
                 int* w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  cinfo.scale_num = 1;
  cinfo.scale_denom = scale_denom;
  jpeg_calc_output_dimensions(&cinfo);
  *h = cinfo.output_height;
  *w = cinfo.output_width;
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int pt_jpeg_decode(const uint8_t* buf, size_t len, uint8_t* out, int out_h,
                   int out_w, int scale_denom) {
  return decode_one(buf, len, out, out_h, out_w, scale_denom);
}

// Decode n JPEGs with a thread pool. outs[i] must hold hs[i]*ws[i]*3 bytes.
// Returns the number of failed decodes (status[i] != 0 marks failures).
int pt_jpeg_decode_batch(const uint8_t** bufs, const size_t* lens,
                         uint8_t** outs, const int* hs, const int* ws,
                         int scale_denom, int n, int num_threads,
                         int* status) {
  if (num_threads < 1) num_threads = 1;
  std::vector<std::thread> pool;
  std::vector<int> fails(num_threads, 0);
  const int shard = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    pool.emplace_back([&, t]() {
      const int lo = t * shard;
      const int hi = lo + shard < n ? lo + shard : n;
      for (int i = lo; i < hi; ++i) {
        status[i] = decode_one(bufs[i], lens[i], outs[i], hs[i], ws[i],
                               scale_denom);
        if (status[i]) ++fails[t];
      }
    });
  }
  int total = 0;
  for (int t = 0; t < num_threads; ++t) {
    pool[t].join();
    total += fails[t];
  }
  return total;
}

}  // extern "C"
