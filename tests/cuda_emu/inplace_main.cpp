// inplace n c0t S.bin out.bin: gpr_panel_inplace (K17) on the float32 (n, n)
// row-major buffer read from S.bin, its panel at tile column c0t factored in
// place; the whole buffer written to out.bin.
#include "emu.h"

extern "C" int gpr_panel_inplace(float* S, int n, int c0t, float* W, float* WS, void* stream);

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int n = atoi(argv[1]), c0t = atoi(argv[2]);
  std::vector<float> S((size_t)n * n), W(256 * 256, 777.0f), WS(7 * 32 * 480 + 8 * 1024, 777.0f);
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(S.data(), 4, S.size(), f) != S.size()) return 3;
  fclose(f);
  const int rc = gpr_panel_inplace(S.data(), n, c0t, W.data(), WS.data(), nullptr);
  if (rc) return 10 + rc;
  f = fopen(argv[4], "wb");
  fwrite(S.data(), 4, S.size(), f);
  fclose(f);
  return 0;
}
