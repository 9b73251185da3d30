// gram batched B n d form P.bin X.bin K.bin
//   gpr_gram_batched of the (B, n, d) X and the (B, 4) parameter rows P;
// gram tile n m d form sigma scale third diag tril X.bin Y.bin K.bin
//   gpr_gram of the (n, d) X and the (m, d) Y (Y.bin may name X.bin).
// The output buffer is filled with 12345 before the call and written whole.
// EMU_SMS sets the multiprocessor count the launcher sees (emu.h).
#include <string>

#include "emu.h"

extern "C" int gpr_gram(const float* X, const float* Y, float* K, int n, int m, int d, int form, float sigma,
                        float scale, float third, float diag, int tril, void* stream);
extern "C" int gpr_gram_batched(const float* X, const float* P, float* K, int B, int n, int d, int form,
                                void* stream);

static bool load(const char* path, std::vector<float>& v) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  const bool ok = fread(v.data(), 4, v.size(), f) == v.size();
  fclose(f);
  return ok;
}

static void save(const char* path, const std::vector<float>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

int main(int argc, char** argv) {
  if (argc < 2) return 2;
  const std::string mode = argv[1];
  if (mode == "batched" && argc == 9) {
    const int B = atoi(argv[2]), n = atoi(argv[3]), d = atoi(argv[4]), form = atoi(argv[5]);
    std::vector<float> P((size_t)B * 4), X((size_t)B * n * d), K((size_t)B * n * n, 12345.0f);
    if (!load(argv[6], P) || !load(argv[7], X)) return 3;
    const int rc = gpr_gram_batched(X.data(), P.data(), K.data(), B, n, d, form, nullptr);
    if (rc) return 10 + rc;
    save(argv[8], K);
    return 0;
  }
  if (mode == "tile" && argc == 14) {
    const int n = atoi(argv[2]), m = atoi(argv[3]), d = atoi(argv[4]), form = atoi(argv[5]);
    const float sigma = atof(argv[6]), scale = atof(argv[7]), third = atof(argv[8]), diag = atof(argv[9]);
    const int tril = atoi(argv[10]);
    std::vector<float> X((size_t)n * d), Y((size_t)m * d), K((size_t)n * m, 12345.0f);
    if (!load(argv[11], X) || !load(argv[12], Y)) return 3;
    const int rc = gpr_gram(X.data(), Y.data(), K.data(), n, m, d, form, sigma, scale, third, diag, tril, nullptr);
    if (rc) return 10 + rc;
    save(argv[13], K);
    return 0;
  }
  return 2;
}
