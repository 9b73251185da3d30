// leaf s lda inplace A.bin L.bin [W.bin]: L (s, s) = gpr_leaf_chol (K12) of
// the float32 leaf read from A.bin, an (s, lda) row-major buffer (row stride
// lda), into a separate (s, s) buffer, or over A itself when inplace is 1;
// written to L.bin.  With W.bin, gpr_leaf_chol_wi (K13) in its place, and W
// (s, s) = L^-1 written there.  Prints the clusters gpr_leaf_chol_clusters
// reports.
// leaf inv s ldl L.bin W.bin: W (s, s) = gpr_tri_inv_leaf (K14) of the
// lower triangle of the float32 (s, ldl) buffer in L.bin, written to W.bin;
// run twice on one set of flags, the two W bit-identical.
// Both modes check that the flags (zero at the launch) come back zero and
// that nothing is written past the scratch or the flags.
#include "emu.h"

extern "C" int gpr_leaf_chol(const float* A, int lda, float* L, int ldl, float* WS, int s, void* stream);
extern "C" int gpr_leaf_chol_clusters(int s, int* out);
extern "C" int gpr_leaf_chol_wi(const float* A, int lda, float* L, int ldl, float* W, int ldw, float* WS,
                                int* flags, int s, void* stream);
extern "C" int gpr_tri_inv_leaf(const float* L, int ldl, float* W, int ldw, float* WS, int* flags, int s,
                                void* stream);
extern "C" int gpr_tri_inv_leaf_scratch(int s, int* out);
extern "C" int gpr_tri_inv_leaf_flags(int* out);

static const int kGuard = 4096;

static bool read_file(const char* path, std::vector<float>& v) {
  FILE* f = fopen(path, "rb");
  const bool ok = f && fread(v.data(), 4, v.size(), f) == v.size();
  if (f) fclose(f);
  return ok;
}

static void write_file(const char* path, const std::vector<float>& v) {
  FILE* f = fopen(path, "wb");
  fwrite(v.data(), 4, v.size(), f);
  fclose(f);
}

// the scratch (used floats, then a guard) and the flags (as many ints as
// gpr_tri_inv_leaf_flags says, zero, then a guard)
struct Scratch {
  std::vector<float> ws;
  std::vector<int> flags;
  size_t used;
  int nflags = 0;
  explicit Scratch(size_t n) : ws(n + kGuard, 777.0f), used(n) {
    gpr_tri_inv_leaf_flags(&nflags);
    flags.assign(nflags + kGuard, 0);
    for (int e = nflags; e < nflags + kGuard; ++e) flags[e] = -5;
  }
  bool intact() const {
    for (int e = 0; e < nflags; ++e)
      if (flags[e] != 0) return false;
    for (int e = 0; e < kGuard; ++e)
      if (ws[used + e] != 777.0f || flags[nflags + e] != -5) return false;
    return true;
  }
};

static int inv_main(int argc, char** argv) {
  if (argc != 6) return 2;
  const int s = atoi(argv[2]), ldl = atoi(argv[3]);
  std::vector<float> L((size_t)s * ldl), W((size_t)s * s, 12345.0f);
  if (!read_file(argv[4], L)) return 3;
  int floats = 0;
  if (gpr_tri_inv_leaf_scratch(s, &floats)) return 4;
  printf("scratch %d\n", floats);
  Scratch sc(floats);
  int rc = gpr_tri_inv_leaf(L.data(), ldl, W.data(), s, sc.ws.data(), sc.flags.data(), s, nullptr);
  if (rc) return 10 + rc;
  if (!sc.intact()) return 5;
  std::vector<float> W2((size_t)s * s, -1.0f);
  rc = gpr_tri_inv_leaf(L.data(), ldl, W2.data(), s, sc.ws.data(), sc.flags.data(), s, nullptr);
  if (rc) return 10 + rc;
  if (!sc.intact() || memcmp(W.data(), W2.data(), 4 * W.size())) return 6;
  write_file(argv[5], W);
  return 0;
}

int main(int argc, char** argv) {
  if (argc > 1 && !strcmp(argv[1], "inv")) return inv_main(argc, argv);
  if (argc != 6 && argc != 7) return 2;
  const int s = atoi(argv[1]), lda = atoi(argv[2]), inplace = atoi(argv[3]);
  const int nt = s / 32;
  const bool wi = argc == 7;
  int floats = 0;
  if (gpr_tri_inv_leaf_scratch(s, &floats)) return 4;
  const size_t k12 = (size_t)nt * (nt * 1024 + 32);
  std::vector<float> A((size_t)s * lda), L((size_t)s * s, 12345.0f), W((size_t)s * s, 12345.0f);
  Scratch sc(wi && (size_t)floats > k12 ? (size_t)floats : k12);
  if (!read_file(argv[4], A)) return 3;
  int clusters = -1;
  if (gpr_leaf_chol_clusters(s, &clusters)) return 4;
  printf("clusters %d\n", clusters);
  float* Lp = inplace ? A.data() : L.data();
  const int ldl = inplace ? lda : s;
  const int rc = wi ? gpr_leaf_chol_wi(A.data(), lda, Lp, ldl, W.data(), s, sc.ws.data(), sc.flags.data(), s,
                                       nullptr)
                    : gpr_leaf_chol(A.data(), lda, Lp, ldl, sc.ws.data(), s, nullptr);
  if (rc) return 10 + rc;
  if (!sc.intact()) return 5;
  if (inplace)
    for (int r = 0; r < s; ++r) memcpy(&L[(size_t)r * s], &A[(size_t)r * lda], 4 * s);
  write_file(argv[5], L);
  if (wi) write_file(argv[6], W);
  return 0;
}
