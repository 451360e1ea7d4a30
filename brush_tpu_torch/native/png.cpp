// PNG row unfiltering (PNG specification, section 9) for datasets/png.py.
//
// Average and Paeth rows depend on the byte bpp to their left, so a row is
// a sequential loop; in C it runs at memory speed, and through ctypes it
// releases the interpreter lock, so the loader's threads decode views in
// parallel.

#include <cstdint>
#include <cstdlib>

extern "C" {

// rows: height scanlines of 1 + stride bytes (filter byte, then the
// filtered bytes); out: height * stride bytes. Returns 0, or 1 + the index
// of the first row whose filter byte is above 4.
int64_t png_unfilter(const uint8_t* rows, int64_t height, int64_t stride,
                     int64_t bpp, uint8_t* out) {
  const uint8_t* prior = nullptr;
  for (int64_t r = 0; r < height; ++r) {
    const uint8_t kind = rows[r * (stride + 1)];
    const uint8_t* f = rows + r * (stride + 1) + 1;
    uint8_t* o = out + r * stride;
    const int64_t lead = bpp < stride ? bpp : stride;
    switch (kind) {
      case 0:
        for (int64_t x = 0; x < stride; ++x) o[x] = f[x];
        break;
      case 1:
        for (int64_t x = 0; x < lead; ++x) o[x] = f[x];
        for (int64_t x = bpp; x < stride; ++x) o[x] = f[x] + o[x - bpp];
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x)
          o[x] = f[x] + (prior ? prior[x] : 0);
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          o[x] = f[x] + ((a + b) >> 1);
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          const int a = x >= bpp ? o[x - bpp] : 0;
          const int b = prior ? prior[x] : 0;
          const int c = (prior && x >= bpp) ? prior[x - bpp] : 0;
          const int pa = std::abs(b - c), pb = std::abs(a - c);
          const int pc = std::abs(a + b - 2 * c);
          o[x] = f[x] + (pa <= pb && pa <= pc ? a : (pb <= pc ? b : c));
        }
        break;
      default:
        return 1 + r;
    }
    prior = o;
  }
  return 0;
}

}  // extern "C"
