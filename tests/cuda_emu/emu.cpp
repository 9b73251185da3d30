// The fiber scheduler of emu.h.
#include "emu.h"

namespace emu {
uint3_ blk, grd;
Fiber* cur;
int nthreads, bar_count, bar_gen, wbar_count[64], wbar_gen[64];
float wbuf[64][32];
float dyn_smem[1 << 16];
static ucontext_t sched;
static std::function<void()>* body_;

void yield() { swapcontext(&cur->ctx, &sched); }

static void trampoline() {
  (*body_)();
  cur->done = true;
  swapcontext(&cur->ctx, &sched);
}

void launch(dim3 grid, dim3 block, std::function<void()> body) {
  body_ = &body;
  nthreads = block.x;
  grd.x = grid.x, grd.y = grid.y, grd.z = grid.z;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blk.x = bx, blk.y = by, blk.z = bz;
        std::vector<Fiber> fs(block.x);
        bar_count = 0;
        memset(wbar_count, 0, sizeof wbar_count);
        for (unsigned t = 0; t < block.x; ++t) {
          fs[t].stack.resize(1 << 16);
          getcontext(&fs[t].ctx);
          fs[t].ctx.uc_stack.ss_sp = fs[t].stack.data();
          fs[t].ctx.uc_stack.ss_size = fs[t].stack.size();
          fs[t].ctx.uc_link = nullptr;
          fs[t].tid.x = t;
          makecontext(&fs[t].ctx, trampoline, 0);
        }
        for (bool running = true; running;) {  // round robin until every thread has returned
          running = false;
          for (auto& f : fs)
            if (!f.done) {
              running = true;
              cur = &f;
              swapcontext(&sched, &f.ctx);
            }
        }
      }
}
}  // namespace emu
