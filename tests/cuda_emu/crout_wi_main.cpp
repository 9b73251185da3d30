// crout_wi B b ld inplace A.bin L.bin W.bin: gpr_crout_chol_wi of B float32
// tiles of b rows, row stride ld >= b and batch stride b * ld, read from
// A.bin; L's buffer of the same layout (filled with 12345 before the call, or
// A's buffer itself when inplace is 1) is written whole to L.bin, W's (its
// own buffer of the same layout, filled with 12345) to W.bin.
#include "emu.h"

extern "C" int gpr_crout_chol_wi(const float* A, long long a_bs, int a_ld, float* L, long long l_bs, int l_ld,
                                 float* W, long long w_bs, int w_ld, int B, int b, void* stream);

int main(int argc, char** argv) {
  if (argc != 8) return 2;
  const int B = atoi(argv[1]), b = atoi(argv[2]), ld = atoi(argv[3]), inplace = atoi(argv[4]);
  const size_t size = (size_t)B * b * ld;
  const long long bs = (long long)b * ld;
  std::vector<float> A(size), L(size, 12345.0f), W(size, 12345.0f);
  FILE* f = fopen(argv[5], "rb");
  if (!f || fread(A.data(), 4, size, f) != size) return 3;
  fclose(f);
  float* out = inplace ? A.data() : L.data();
  const int rc = gpr_crout_chol_wi(A.data(), bs, ld, out, bs, ld, W.data(), bs, ld, B, b, nullptr);
  if (rc) return 10 + rc;
  f = fopen(argv[6], "wb");
  fwrite(out, 4, size, f);
  fclose(f);
  f = fopen(argv[7], "wb");
  fwrite(W.data(), 4, size, f);
  fclose(f);
  return 0;
}
