// leaf s lda inplace A.bin L.bin [W.bin]: L (s, s) = gpr_leaf_chol (K12) of
// the float32 leaf read from A.bin, an (s, lda) row-major buffer (row stride
// lda), into a separate (s, s) buffer, or over A itself when inplace is 1;
// written to L.bin.  With W.bin, gpr_leaf_chol_wi (K13) in its place, and W
// (s, s) = L^-1 written there.  Prints the clusters gpr_leaf_chol_clusters
// reports.
#include "emu.h"

extern "C" int gpr_leaf_chol(const float* A, int lda, float* L, int ldl, float* WS, int s, void* stream);
extern "C" int gpr_leaf_chol_clusters(int s, int* out);
extern "C" int gpr_leaf_chol_wi(const float* A, int lda, float* L, int ldl, float* W, int ldw, float* WS, int s,
                                void* stream);

int main(int argc, char** argv) {
  if (argc != 6 && argc != 7) return 2;
  const int s = atoi(argv[1]), lda = atoi(argv[2]), inplace = atoi(argv[3]);
  const int nt = s / 32;
  const bool wi = argc == 7;
  std::vector<float> A((size_t)s * lda), L((size_t)s * s, 12345.0f), W((size_t)s * s, 12345.0f),
      WS((size_t)nt * (nt * 1024 + 32), 777.0f);
  FILE* f = fopen(argv[4], "rb");
  if (!f || fread(A.data(), 4, A.size(), f) != A.size()) return 3;
  fclose(f);
  int clusters = -1;
  if (gpr_leaf_chol_clusters(s, &clusters)) return 4;
  printf("clusters %d\n", clusters);
  float* Lp = inplace ? A.data() : L.data();
  const int ldl = inplace ? lda : s;
  const int rc = wi ? gpr_leaf_chol_wi(A.data(), lda, Lp, ldl, W.data(), s, WS.data(), s, nullptr)
                    : gpr_leaf_chol(A.data(), lda, Lp, ldl, WS.data(), s, nullptr);
  if (rc) return 10 + rc;
  if (inplace)
    for (int r = 0; r < s; ++r) memcpy(&L[(size_t)r * s], &A[(size_t)r * lda], 4 * s);
  f = fopen(argv[5], "wb");
  fwrite(L.data(), 4, L.size(), f);
  fclose(f);
  if (wi) {
    f = fopen(argv[6], "wb");
    fwrite(W.data(), 4, W.size(), f);
    fclose(f);
  }
  return 0;
}
