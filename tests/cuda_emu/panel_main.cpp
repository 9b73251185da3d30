// panel n ldp P.bin out.bin: out (n, 256) = gpr_panel_factor (K15) of the
// float32 panel read from P.bin, an (n, ldp) row-major buffer of which the
// first 256 columns are the panel; written to out.bin.
#include "emu.h"

extern "C" int gpr_panel_factor(const float* P, int ldp, float* out, float* W, float* WS, int n, void* stream);

int main(int argc, char** argv) {
  if (argc != 5) return 2;
  const int n = atoi(argv[1]), ldp = atoi(argv[2]);
  std::vector<float> P((size_t)n * ldp), out((size_t)n * 256, 12345.0f), W(256 * 256, 777.0f),
      WS(7 * 32 * 480 + 8 * 1024, 777.0f);
  FILE* f = fopen(argv[3], "rb");
  if (!f || fread(P.data(), 4, P.size(), f) != P.size()) return 3;
  fclose(f);
  const int rc = gpr_panel_factor(P.data(), ldp, out.data(), W.data(), WS.data(), n, nullptr);
  if (rc) return 10 + rc;
  f = fopen(argv[4], "wb");
  fwrite(out.data(), 4, out.size(), f);
  fclose(f);
  return 0;
}
