// The fiber scheduler of emu.h.
#include "emu.h"

uint3_ threadIdx, blockIdx, gridDim;

namespace emu {
Fiber* cur;
int nthreads;
float* dyn_smem;
static float plain_smem[1 << 16];  // a plain launch's dynamic shared memory
static ucontext_t sched;
static std::function<void()>* body_;
static int cl_threads, cl_done;         // threads of the cluster, its completed barrier phases
static std::vector<int> cl_arrived;     // arrivals per phase

void yield() { swapcontext(&cur->ctx, &sched); }

static void trampoline() {
  (*body_)();
  cur->done = true;
  swapcontext(&cur->ctx, &sched);
}

// Run the threads of `ctas` (nthreads each) as fibers until all return,
// switching only to fibers that are not blocked.
static void run(std::vector<Cta>& ctas, size_t stack_bytes) {
  std::vector<Fiber> fs(ctas.size() * nthreads);
  for (size_t i = 0; i < fs.size(); ++i) {
    Fiber& f = fs[i];
    f.stack.reset(new char[stack_bytes]);
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = stack_bytes;
    f.ctx.uc_link = nullptr;
    f.tid.x = i % nthreads;
    f.cta = &ctas[i / nthreads];
    makecontext(&f.ctx, trampoline, 0);
  }
  for (size_t left = fs.size(); left;) {
    bool moved = false;
    for (auto& f : fs) {
      if (f.done || (f.wait_on && *f.wait_on == f.wait_val)) continue;
      f.wait_on = nullptr;
      moved = true;
      cur = &f;
      dyn_smem = f.cta->smem ? f.cta->smem : plain_smem;
      threadIdx = f.tid;
      blockIdx = f.cta->blk;
      swapcontext(&sched, &f.ctx);
      left -= f.done;
    }
    if (!moved) {
      fprintf(stderr, "emu: deadlock, %zu threads blocked\n", left);
      abort();
    }
  }
}

void launch(dim3 grid, dim3 block, std::function<void()> body) {
  body_ = &body;
  nthreads = block.x;
  gridDim.x = grid.x, gridDim.y = grid.y, gridDim.z = grid.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        std::vector<Cta> one(1);
        one[0].blk.x = bx, one[0].blk.y = by, one[0].blk.z = bz;
        run(one, 1 << 16);
      }
}

void launch_cluster(dim3 grid, dim3 block, unsigned cluster, size_t smem_bytes, std::function<void()> body) {
  body_ = &body;
  nthreads = block.x;
  gridDim.x = grid.x, gridDim.y = grid.y, gridDim.z = grid.z;
  for (unsigned c0 = 0; c0 < grid.x; c0 += cluster) {
    std::vector<Cta> ctas(cluster);
    std::vector<std::vector<float>> smem(cluster, std::vector<float>(smem_bytes / sizeof(float) + 4));
    for (unsigned r = 0; r < cluster; ++r) {
      ctas[r].blk.x = c0 + r;
      ctas[r].rank = r;
      ctas[r].smem = smem[r].data();
    }
    cl_threads = cluster * nthreads;
    cl_done = 0;
    cl_arrived.assign(1, 0);
    run(ctas, 1 << 15);
  }
}

void cluster_arrive() {
  const int p = cur->cl_arrives++;
  if ((int)cl_arrived.size() <= p) cl_arrived.resize(p + 1, 0);
  if (++cl_arrived[p] == cl_threads) cl_done = p + 1;
}

void cluster_wait() {
  const int p = cur->cl_arrives - 1;
  if (p < 0) {
    fprintf(stderr, "emu: cluster wait without an arrive\n");
    abort();
  }
  while (cl_done <= p) block_while(&cl_done, cl_done);
}
}  // namespace emu
