// subst n q bs L.bin W.bin B.bin Y.bin X.bin: the two sweeps of gpr_narrow_subst,
// Y = the forward sweep of the float32 (n, q) row-major B and X = the backward
// sweep of Y, with L (n, n) row-major and W (n / bs, bs, bs) read from their
// files; each sweep gets flags of zero and scratch filled with junk.
#include "emu.h"

extern "C" int gpr_narrow_subst(const float* L, const float* W, const float* src, float* out, float* P,
                                float* R, int* flags, int n, int q, int bs, int forward, void* stream);

static bool read(const char* path, std::vector<float>& v) {
  FILE* f = fopen(path, "rb");
  const bool ok = f && fread(v.data(), 4, v.size(), f) == v.size();
  if (f) fclose(f);
  return ok;
}

int main(int argc, char** argv) {
  if (argc != 9) return 2;
  const int n = atoi(argv[1]), q = atoi(argv[2]), bs = atoi(argv[3]), nb = n / bs;
  const int zq = (q + (q <= 8 ? 8 : 16) - 1) / (q <= 8 ? 8 : 16);
  std::vector<float> L((size_t)n * n), W((size_t)n * bs), B((size_t)n * q), Y((size_t)n * q, 12345.0f),
      X((size_t)n * q, 12345.0f);
  if (!read(argv[4], L) || !read(argv[5], W) || !read(argv[6], B)) return 3;
  std::vector<float> P(((size_t)2 * (nb > 1 ? nb - 1 : 1) * bs + n) * (bs / 128) * q), R((size_t)n * q);
  for (int forward = 1; forward >= 0; --forward) {
    std::vector<int> flags(6 * nb * (bs / 64) * zq + 1, 0);
    for (auto& x : P) x = 777.0f;
    for (auto& x : R) x = 777.0f;
    const int rc = gpr_narrow_subst(L.data(), W.data(), forward ? B.data() : Y.data(), forward ? Y.data() : X.data(),
                                    P.data(), R.data(), flags.data(), n, q, bs, forward, nullptr);
    if (rc) return 10 + rc;
  }
  FILE* f = fopen(argv[7], "wb");
  fwrite(Y.data(), 4, Y.size(), f);
  fclose(f);
  f = fopen(argv[8], "wb");
  fwrite(X.data(), 4, X.size(), f);
  fclose(f);
  return 0;
}
