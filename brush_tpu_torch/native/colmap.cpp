// Fast COLMAP binary parsing.
//
// Native equivalent of the reference's binary readers
// (reference: colmap-reader/src/lib.rs:291-443). points3D.bin for a large
// scene holds millions of records with variable-length tracks — a single
// C++ pass replaces per-record Python struct.unpack.

#include <cstdint>
#include <cstring>

namespace {

template <typename T>
T read(const uint8_t*& p) {
  T v;
  std::memcpy(&v, p, sizeof(T));
  p += sizeof(T);
  return v;
}

}  // namespace

extern "C" {

// Number of points, or -1 on malformed data.
int64_t colmap_points3d_count(const uint8_t* data, int64_t len) {
  if (len < 8) return -1;
  const uint8_t* p = data;
  return static_cast<int64_t>(read<uint64_t>(p));
}

// Fills pos (n, 3) float32 and rgb (n, 3) float32 in [0, 1].
// Returns number parsed, or -1 on truncation.
int64_t colmap_points3d_parse(const uint8_t* data, int64_t len, float* pos,
                              float* rgb) {
  const uint8_t* p = data;
  const uint8_t* end = data + len;
  if (end - p < 8) return -1;
  uint64_t n = read<uint64_t>(p);
  for (uint64_t i = 0; i < n; ++i) {
    // id(8) + xyz(24) + rgb(3) + error(8) + track_len(8) = 51 bytes minimum.
    if (end - p < 51) return -1;
    p += 8;  // point id
    for (int a = 0; a < 3; ++a) pos[i * 3 + a] = static_cast<float>(read<double>(p));
    for (int a = 0; a < 3; ++a) rgb[i * 3 + a] = static_cast<float>(*p++) / 255.0f;
    p += 8;  // reprojection error
    uint64_t track = read<uint64_t>(p);
    // Divide, don't multiply: a corrupt track_len near 2^61 would wrap
    // track * 8 past the bounds check and walk p out of the buffer.
    if (track > static_cast<uint64_t>(end - p) / 8) return -1;
    p += track * 8;
  }
  return static_cast<int64_t>(n);
}

}  // extern "C"
