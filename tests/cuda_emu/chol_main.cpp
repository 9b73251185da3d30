// chol n sw A.bin L.bin: L (n, n) = gpr_tile_chol (sw 1) or
// gpr_tile_chol_strips (sw 8, 16) of the float32 (n, n) row-major A read from
// A.bin, written to L.bin.
#include "emu.h"

extern "C" int gpr_tile_chol(const float* A, float* L, float* W, int n, void* stream);
extern "C" int gpr_tile_chol_strips(const float* A, float* L, float* W, int n, int sw, void* stream);

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int n = atoi(argv[1]), sw = atoi(argv[2]);
  const int nt = (n + 31) / 32;
  std::vector<float> A((size_t)n * n), L((size_t)n * n, 12345.0f), W((nt > 1 ? nt - 1 : 1) * 32 * 480, 777.0f);
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(A.data(), 4, A.size(), f) != A.size()) return 3;
  fclose(f);
  const int rc = sw == 1 ? gpr_tile_chol(A.data(), L.data(), W.data(), n, nullptr)
                         : gpr_tile_chol_strips(A.data(), L.data(), W.data(), n, sw, nullptr);
  if (rc) return 10 + rc;
  f = fopen(argv[4], "wb");
  fwrite(L.data(), 4, L.size(), f);
  fclose(f);
  return 0;
}
