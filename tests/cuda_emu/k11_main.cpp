// k11 n bs L.bin W.bin: W (n / bs, bs, bs) = gpr_diag_tri_inv of the float32
// (n, n) row-major L read from L.bin, written to W.bin.
#include "emu.h"

extern "C" int gpr_diag_tri_inv(const float* L, int ld, float* W, int nb, int bs, void* stream);

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int n = atoi(argv[1]), bs = atoi(argv[2]);
  std::vector<float> L((size_t)n * n), W((size_t)n * n, 12345.0f);
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(L.data(), 4, L.size(), f) != L.size()) return 3;
  fclose(f);
  const int rc = gpr_diag_tri_inv(L.data(), n, W.data(), n / bs, bs, nullptr);
  if (rc) return 10 + rc;
  f = fopen(argv[4], "wb");
  fwrite(W.data(), 4, (size_t)(n / bs) * bs * bs, f);
  fclose(f);
  return 0;
}
