// Native host-side runtime helpers for easy_gaussian_splatting_torch (the
// port's own copy of the JAX package's egs_native.cpp, unchanged below this
// note).
//
// The device compute path is PyTorch and the CUDA kernels of csrc/; these
// are the host data-path hot spots where a C++ implementation is 20-50x
// faster than Python record loops:
//   - COLMAP points3D.bin parsing (variable-length track records; parsed
//     per record in Python, a multi-million-point scene takes tens of
//     seconds)
//   - COLMAP images.bin pose extraction
//   - binary mask dilation with the (2e x 2e) shifted window
//
// Compiled with the host C++ compiler at first use into build/native/ at
// the repository root and called through ctypes; every entry point has a
// pure-Python fallback.

#include <cstdint>
#include <cstring>

extern "C" {

// points3D.bin layout (little-endian):
//   uint64 num_points
//   per point: uint64 id, 3x f64 xyz, 3x u8 rgb, f64 error,
//              uint64 track_len, track_len x (int32, int32)
// Fills xyz [n,3] float32 and rgb [n,3] uint8; returns the number of
// points parsed, or -1 if the buffer is malformed/truncated.
long long parse_points3d(const uint8_t* buf, unsigned long long len,
                         float* xyz, uint8_t* rgb,
                         unsigned long long max_points) {
  if (len < 8) return -1;
  uint64_t n;
  std::memcpy(&n, buf, 8);
  if (n > max_points) return -1;
  unsigned long long off = 8;
  for (uint64_t i = 0; i < n; ++i) {
    if (off + 51 > len) return -1;
    double v[3];
    std::memcpy(v, buf + off + 8, 24);
    xyz[i * 3 + 0] = static_cast<float>(v[0]);
    xyz[i * 3 + 1] = static_cast<float>(v[1]);
    xyz[i * 3 + 2] = static_cast<float>(v[2]);
    std::memcpy(rgb + i * 3, buf + off + 32, 3);
    uint64_t track_len;
    std::memcpy(&track_len, buf + off + 43, 8);
    off += 51 + 8 * track_len;
    if (off > len) return -1;
  }
  return static_cast<long long>(n);
}

// images.bin layout:
//   uint64 num_images
//   per image: int32 id, 4x f64 quat(wxyz), 3x f64 trans, int32 camera_id,
//              null-terminated name, uint64 n2d, n2d x (f64,f64,int64)
// Fills ids [n], camera_ids [n], quats [n,4] f64, trans [n,3] f64, and
// names as a flat \0-separated byte array (name_buf of name_buf_len).
// Returns the number of images, or -1 on malformed input / overflow.
long long parse_images(const uint8_t* buf, unsigned long long len,
                       int32_t* ids, int32_t* camera_ids, double* quats,
                       double* trans, uint8_t* name_buf,
                       unsigned long long name_buf_len,
                       unsigned long long max_images) {
  if (len < 8) return -1;
  uint64_t n;
  std::memcpy(&n, buf, 8);
  if (n > max_images) return -1;
  unsigned long long off = 8;
  unsigned long long name_off = 0;
  for (uint64_t i = 0; i < n; ++i) {
    if (off + 64 > len) return -1;
    std::memcpy(&ids[i], buf + off, 4);
    std::memcpy(&quats[i * 4], buf + off + 4, 32);
    std::memcpy(&trans[i * 3], buf + off + 36, 24);
    std::memcpy(&camera_ids[i], buf + off + 60, 4);
    off += 64;
    // name (null-terminated)
    unsigned long long start = off;
    while (off < len && buf[off] != 0) ++off;
    if (off >= len) return -1;
    unsigned long long name_len = off - start + 1;  // include the \0
    if (name_off + name_len > name_buf_len) return -1;
    std::memcpy(name_buf + name_off, buf + start, name_len);
    name_off += name_len;
    ++off;  // skip the \0
    if (off + 8 > len) return -1;
    uint64_t n2d;
    std::memcpy(&n2d, buf + off, 8);
    off += 8 + 24 * n2d;
    if (off > len) return -1;
  }
  return static_cast<long long>(n);
}

// Binary mask dilation with the reference's asymmetric (2e x 2e) window:
// out[y][x] = 1 iff any in[y'][x'] with y' in [y-e+1, y+e],
// x' in [x-e+1, x+e]. Separable two-pass implementation, O(h*w*e).
void dilate_mask(const uint8_t* in, uint8_t* out, uint8_t* tmp, int h,
                 int w, int e) {
  // horizontal pass into tmp
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + (long long)y * w;
    uint8_t* trow = tmp + (long long)y * w;
    for (int x = 0; x < w; ++x) {
      uint8_t v = 0;
      int x0 = x - e + 1;
      if (x0 < 0) x0 = 0;
      int x1 = x + e;
      if (x1 >= w) x1 = w - 1;
      for (int xx = x0; xx <= x1; ++xx) {
        if (row[xx]) { v = 1; break; }
      }
      trow[x] = v;
    }
  }
  // vertical pass into out
  for (int y = 0; y < h; ++y) {
    int y0 = y - e + 1;
    if (y0 < 0) y0 = 0;
    int y1 = y + e;
    if (y1 >= h) y1 = h - 1;
    uint8_t* orow = out + (long long)y * w;
    for (int x = 0; x < w; ++x) {
      uint8_t v = 0;
      for (int yy = y0; yy <= y1; ++yy) {
        if (tmp[(long long)yy * w + x]) { v = 1; break; }
      }
      orow[x] = v;
    }
  }
}

}  // extern "C"
