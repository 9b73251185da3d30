// fleet B n p q A.bin Y.bin L.bin X.bin W.bin: gpr_fleet_fused of B float32
// (n, n) matrices and (n, q) right-hand sides read from A.bin and Y.bin, at
// panel p; L (B, n, n), alpha (B, n, q) and W (B, n / p, p, p), each buffer
// filled with 12345 before the call, written to L.bin, X.bin and W.bin.
#include "emu.h"

extern "C" int gpr_fleet_fused(const float* A, float* L, const float* Y, float* X, float* W, int B, int n, int p,
                               int q, void* stream);

static bool load(const char* path, std::vector<float>& v) {
  FILE* f = fopen(path, "rb");
  const bool ok = f && fread(v.data(), 4, v.size(), f) == v.size();
  if (f) fclose(f);
  return ok;
}

static void save(const char* path, const std::vector<float>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc != 10) return 2;
  const int B = atoi(argv[1]), n = atoi(argv[2]), p = atoi(argv[3]), q = atoi(argv[4]);
  std::vector<float> A((size_t)B * n * n), Y((size_t)B * n * q), L(A.size(), 12345.0f), X(Y.size(), 12345.0f),
      W((size_t)B * n * p, 12345.0f);
  if (!load(argv[5], A) || !load(argv[6], Y)) return 3;
  const int rc = gpr_fleet_fused(A.data(), L.data(), Y.data(), X.data(), W.data(), B, n, p, q, nullptr);
  if (rc) return 10 + rc;
  save(argv[7], L);
  save(argv[8], X);
  save(argv[9], W);
  return 0;
}
