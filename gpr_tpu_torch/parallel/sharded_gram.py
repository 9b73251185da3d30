"""Distributed Gram, Cholesky and solve over the ranks of a device mesh (block rows).

Mirrors gpr_tpu/parallel/sharded_gram.py:1-298 (``default_mesh``,
``sharded_gram``, ``_chol_panels``, ``cholesky_sharded``,
``_add_diag_sharded``, ``_diag_mean_sharded``, ``safe_cholesky_sharded``,
``_forward_solve``, ``_backward_solve``, ``cho_solve_sharded``,
``fit_sharded``).  The GP's n axis is split over the ranks of one dimension
of a ``torch.distributed.device_mesh.DeviceMesh``: rank r of D holds block
row r, the (nb, n) rows r nb .. (r + 1) nb of K and of L (nb = n / D).  Per
column block k:

  1. the owner k broadcasts its diagonal block, every rank factors it
     (``ops.blocked.cholesky_blocked``: on the card in float32 its trailing
     updates are K5);
  2. each rank below the owner solves its own (nb, nb) block of the panel;
  3. each block of the panel below the owner is broadcast from its rank, and
     each rank updates its rows' remaining columns on or below the diagonal
     (``Tensor.addmm_``, in place).

The substitutions broadcast each solved block from its owner; the backward
one all-reduces the partial sums of the ranks below.  Where JAX adds zeros
from every device (a masked ``psum``) the port broadcasts from the owner,
which gives the same values, since adding an exact zero is exact in IEEE;
a true sum of partials is an all-reduce, ``lax.axis_index`` the rank in the
mesh dimension.  JAX all-gathers the (n, nb) panel (:98); the port
broadcasts its (nb, nb) blocks one by one, the same bytes without an (n, nb)
buffer.  JAX computes the panel solve on every device and keeps it only
below the owner (sharded_gram.py:91-94), updates the columns above the
diagonal that later panels zero, and solves against an identity off the
owner in the backward substitution (:230); the port computes each only
where it is kept.  Every collective is synchronous.

Memory: the factor overwrites its block row, so ``fit_sharded``'s rank
holds its (nb, n) block row of K, which becomes its rows of L, a few
(nb, nb) blocks (the diagonal block, its factor, a panel block, the
blocked solve's pieces) and the Gram's runs of rows (``_GRAM_CHUNK``).
``cholesky_sharded`` and ``safe_cholesky_sharded`` keep the caller's K and
factor a copy.

Inputs that JAX replicates (X, Y, the right-hand side) are passed whole to
every rank; ``alpha`` and ``logdet`` come back the same on every rank.  A
row-sharded array (K, L) is the rank's (nb, n) block; a function that takes
one also accepts the whole (n, n) matrix and keeps the rank's rows.
``safe_cholesky_sharded``'s jitter loop runs on the host, as the port's
``linalg.safe_cholesky`` does: the last rank holds L[-1, -1], whose
finiteness it broadcasts, one host read a try.  Each collective is the span
``gpr.sharded.collective`` (utils/profiling.py).

The mesh's backend follows its device, NCCL for CUDA and gloo for the CPU.
Where no process group exists, :func:`default_mesh` joins the world that
``torchrun`` describes in the environment, or else starts a world of one
(a ``HashStore``), so one process works as JAX's one-device mesh does; on
the card that world is a real NCCL group.  ``parallel.sharded_hmc
.initialize_distributed`` starts a world from a coordinator's address.  Each
rank runs on the card ``LOCAL_RANK % device_count``.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..kernels import kernels as kermod
from ..ops.blocked import cholesky_blocked, solve_triangular_blocked
from ..utils import config
from ..utils.profiling import count, host_wait, span

_MESHES: dict = {}  # (world, device type, shape, names) -> DeviceMesh


def backend_for(device_type: str) -> str:
    """The process group backend for tensors of ``device_type``."""
    return "nccl" if device_type == "cuda" else "gloo"


def set_local_device() -> None:
    """Make ``cuda:{LOCAL_RANK % device_count}`` this process's card, as a
    rank must before its group starts."""
    local = int(os.environ.get("LOCAL_RANK", "0"))
    torch.cuda.set_device(local % torch.cuda.device_count())


def _join_world(device) -> torch.device:
    """``device`` resolved (the card unless told), and a process group that
    exists: torchrun's world where its environment is set (``WORLD_SIZE``,
    ``MASTER_ADDR``), else a world of one."""
    dev = config.resolve_device(device)
    if not dist.is_initialized():
        if dev.type == "cuda":
            set_local_device()
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend_for(dev.type))
        else:
            dist.init_process_group(backend_for(dev.type), store=dist.HashStore(), rank=0, world_size=1)
    return dev


def make_mesh(shape: Sequence[int], names: Sequence[str], device=None):
    """A ``DeviceMesh`` of ``shape`` over the world's ranks (joined or
    started by :func:`_join_world`), dimensions ``names``, on ``device``'s
    type.  Cached per world and layout, as a mesh of more than one dimension
    makes process groups."""
    from torch.distributed.device_mesh import init_device_mesh

    dev = _join_world(device)
    shape, names = tuple(int(s) for s in shape), tuple(names)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a mesh of shape {shape} needs {math.prod(shape)} ranks; the world has {world}")
    key = (id(dist.group.WORLD), dev.type, shape, names)
    if key not in _MESHES:
        _MESHES[key] = init_device_mesh(dev.type, shape, mesh_dim_names=names)
    return _MESHES[key]


def shutdown() -> None:
    """Forget this process's meshes and destroy its process group."""
    _MESHES.clear()
    if dist.is_initialized():
        dist.destroy_process_group()


def default_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None):
    """A 1-D mesh over every rank of the world, dimension ``axis``
    (sharded_gram.py:40-44).  ``n_devices``, if given, must be the world's
    size: a torch mesh spans every rank of its group."""
    _join_world(device)
    return make_mesh((dist.get_world_size() if n_devices is None else n_devices,), (axis,), device)


def mesh_device(mesh) -> torch.device:
    """The device a mesh's rank computes on: its card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class _Axis:
    """One dimension of a mesh seen from this rank: its group, the rank in
    it (``lax.axis_index``) and its size."""

    def __init__(self, mesh, axis: str):
        self.group = mesh.get_group(axis)
        self.rank = dist.get_rank(self.group)
        self.size = dist.get_world_size(self.group)

    def broadcast(self, t: torch.Tensor, owner: int) -> torch.Tensor:
        with span("gpr.sharded.collective"):
            dist.broadcast(t, src=dist.get_global_rank(self.group, owner), group=self.group)
        return t

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        with span("gpr.sharded.collective"):
            dist.all_reduce(t, group=self.group)
        return t

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.pmean``: the mean over the ranks, on every rank."""
        return self.all_reduce(t.reshape(-1).clone()).reshape(t.shape) / self.size

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim`` in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.size)]
        with span("gpr.sharded.collective"):
            dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts, dim)

    def rows(self, K: torch.Tensor) -> Tuple[torch.Tensor, int]:
        """(the rank's (nb, n) block of K, nb): K is that block or all of K."""
        n = K.shape[1]
        if n % self.size:
            raise ValueError(f"n ({n}) must be divisible by mesh axis size ({self.size})")
        nb = n // self.size
        if K.shape[0] == n and self.size > 1:
            K = K[self.rank * nb:(self.rank + 1) * nb]
        elif K.shape[0] != nb:
            raise ValueError(f"K has {K.shape[0]} rows; expected {nb} (one block row) or {n}")
        return K, nb


_GRAM_CHUNK = 1 << 26  # elements of K a Gram call makes at once (256 MiB in float32)


def sharded_gram(kernel, X, mesh, axis: str = "data") -> torch.Tensor:
    """The rank's block row K(X_rank, X) (nb, n) of the Gram matrix, X (n, d)
    given whole to every rank (sharded_gram.py:47-62).  Made in runs of
    rows of at most ``_GRAM_CHUNK`` entries, so that the kernel's temporaries
    stay small beside the block row."""
    ax = _Axis(mesh, axis)
    X = config.as_input(X, mesh_device(mesh))
    n = X.shape[0]
    if n % ax.size:
        raise ValueError(f"n ({n}) must be divisible by mesh axis size ({ax.size})")
    nb = n // ax.size
    rows = X[ax.rank * nb:(ax.rank + 1) * nb]
    step = max(1, _GRAM_CHUNK // n)
    if step >= nb:
        return kermod.gram(kernel, rows, X)
    K = None
    for i in range(0, nb, step):
        blk = kermod.gram(kernel, rows[i:i + step], X)
        if K is None:
            K = blk.new_empty((nb, n))
        K[i:i + step] = blk
    return K


def _chol_panels(A: torch.Tensor, ax: _Axis, nb: int) -> torch.Tensor:
    """Block-row right-looking Cholesky of the rank's rows (nb, n), in place:
    A becomes the rank's rows of L (sharded_gram.py:65-113).  Column block k
    of A takes the panel's rows where JAX keeps a list of panels, and each
    solved block of the panel is broadcast from its rank where JAX
    all-gathers the whole (n, nb) panel, so a rank holds A and a few
    (nb, nb) blocks.  Rank r updates only its column blocks k + 1 .. r: the
    rest lies above the diagonal, where L is zero."""
    my, D = ax.rank, ax.size
    for k in range(D):
        C = A[:, k * nb:(k + 1) * nb]
        Ckk = C.contiguous() if my == k else torch.empty_like(C, memory_format=torch.contiguous_format)
        Lkk = cholesky_blocked(ax.broadcast(Ckk, k))
        del Ckk
        if my == k:
            C.copy_(Lkk)
        elif my > k:
            C.copy_(solve_triangular_blocked(Lkk, C.mT).mT)
        else:
            C.zero_()
        del Lkk
        for j in range(k + 1, D):
            Pj = C.contiguous() if my == j else torch.empty_like(C, memory_format=torch.contiguous_format)
            ax.broadcast(Pj, j)
            if my >= j:
                A[:, j * nb:(j + 1) * nb].addmm_(C, Pj.mT, alpha=-1)
    return A


def cholesky_sharded(K: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """The rank's rows of the lower Cholesky factor of K, K the rank's block
    row or all of K, which stays as it was (sharded_gram.py:116-126)."""
    ax = _Axis(mesh, axis)
    K_local, nb = ax.rows(K)
    return _chol_panels(K_local.clone(memory_format=torch.contiguous_format), ax, nb)


def _add_diag_(K_local: torch.Tensor, val, ax: _Axis, nb: int) -> torch.Tensor:
    """K + val I on the rank's block row, in place."""
    K_local[:, ax.rank * nb:(ax.rank + 1) * nb].diagonal().add_(
        torch.as_tensor(val, dtype=K_local.dtype, device=K_local.device))
    return K_local


def _add_diag_sharded(K_local: torch.Tensor, val, mesh, axis: str) -> torch.Tensor:
    """K + val I for the rank's block row, a new tensor (sharded_gram.py:129-141)."""
    ax = _Axis(mesh, axis)
    K_local, nb = ax.rows(K_local)
    return _add_diag_(K_local.clone(memory_format=torch.contiguous_format), val, ax, nb)


def _diag_mean_sharded(K_local: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """mean |diag(K)| over all n, on every rank (sharded_gram.py:144-154)."""
    ax = _Axis(mesh, axis)
    K_local, nb = ax.rows(K_local)
    blk = K_local[:, ax.rank * nb:(ax.rank + 1) * nb]
    return ax.all_reduce(blk.diagonal().abs().sum().reshape(1))[0] / K_local.shape[1]


def _last_pivot_ok(L_local: torch.Tensor, ax: _Axis) -> bool:
    """Whether the global L[-1, -1] is finite: a failed pivot propagates NaN
    through every later panel, across ranks (sharded_gram.py:160-162).  The
    last rank holds it and broadcasts one flag."""
    flag = torch.isfinite(L_local[-1:, -1]).to(L_local.dtype)
    host_wait("sharded.ok", flag)
    return bool(ax.broadcast(flag, ax.size - 1)[0] > 0)


def _safe_chol(fresh, ax: _Axis, nb: int, mesh, axis: str, initial_jitter: float, max_tries: int):
    """(L, jitter) of :func:`safe_cholesky_sharded`.  ``fresh(jitter)`` makes
    a new copy of the rank's block row of K + jitter I (of K for None),
    which the factor overwrites, so a try holds one block row."""
    A = fresh(None)
    dtype, device = A.dtype, A.device
    if initial_jitter > 0:
        base = torch.as_tensor(initial_jitter, dtype=dtype, device=device)
    else:  # read before the factor overwrites A; one all-reduce of a scalar
        base = torch.finfo(dtype).eps * torch.clamp(_diag_mean_sharded(A, mesh, axis), min=1.0)
    L = _chol_panels(A, ax, nb)
    count("factor.sharded")
    del A
    jitter = torch.zeros((), dtype=dtype, device=device)
    if _last_pivot_ok(L, ax):
        return L, jitter
    for tries in range(max_tries):
        jitter = base if tries == 0 else jitter * 10.0
        L = None  # the failed factor goes before the next copy is made
        L = _chol_panels(fresh(jitter), ax, nb)
        count("factor.sharded")
        count("retry.sharded")
        if _last_pivot_ok(L, ax):
            break
    return L, jitter


def safe_cholesky_sharded(K: torch.Tensor, mesh, axis: str = "data",
                          initial_jitter: float = 0.0, max_tries: int = 6):
    """(the rank's rows of L, jitter): :func:`cholesky_sharded` with the jitter
    escalation of ``linalg.safe_cholesky`` (sharded_gram.py:157-193).  On
    failure the jitter starts at ``initial_jitter`` or eps * max(mean
    |diag K|, 1) and grows 10x a try, at most ``max_tries`` tries; a K that
    never factors comes back NaN with the last jitter tried.  K stays as it
    was."""
    ax = _Axis(mesh, axis)
    K_local, nb = ax.rows(K)

    def fresh(jitter):
        if jitter is None:
            return K_local.clone(memory_format=torch.contiguous_format)
        return _add_diag_sharded(K_local, jitter, mesh, axis)

    return _safe_chol(fresh, ax, nb, mesh, axis, initial_jitter, max_tries)


def _forward_solve(L_local: torch.Tensor, B: torch.Tensor, ax: _Axis, nb: int) -> torch.Tensor:
    """Y with L Y = B, L row-sharded, B and Y whole on every rank: the owner
    of each block row solves it and broadcasts (sharded_gram.py:196-214)."""
    Y = torch.zeros_like(B)
    for k in range(ax.size):
        if ax.rank == k:
            rhs = B[k * nb:(k + 1) * nb]
            if k > 0:
                rhs = rhs - torch.matmul(L_local[:, :k * nb], Y[:k * nb])
            yk = solve_triangular_blocked(L_local[:, k * nb:(k + 1) * nb], rhs).contiguous()
        else:
            yk = torch.empty_like(B[k * nb:(k + 1) * nb])
        Y[k * nb:(k + 1) * nb] = ax.broadcast(yk, k)
    return Y


def _backward_solve(L_local: torch.Tensor, Ymid: torch.Tensor, ax: _Axis, nb: int) -> torch.Tensor:
    """X with L^T X = Y, bottom-up: the ranks below block k all-reduce their
    partial sums L[rank, k]^T X_rank, the owner solves and broadcasts
    (sharded_gram.py:217-239)."""
    my = ax.rank
    X = torch.zeros_like(Ymid)
    for k in reversed(range(ax.size)):
        Lk_cols = L_local[:, k * nb:(k + 1) * nb]
        if my > k:
            part = torch.matmul(Lk_cols.mT, X[my * nb:(my + 1) * nb])
        else:
            part = torch.zeros_like(Ymid[k * nb:(k + 1) * nb])
        s = ax.all_reduce(part)
        if my == k:
            xk = solve_triangular_blocked(Lk_cols.mT, Ymid[k * nb:(k + 1) * nb] - s, lower=False).contiguous()
        else:
            xk = torch.empty_like(part)
        X[k * nb:(k + 1) * nb] = ax.broadcast(xk, k)
    return X


def cho_solve_sharded(L: torch.Tensor, B: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """X with (L L^T) X = B: L row-sharded (the rank's rows or all of L), B
    (n, q) whole on every rank, X the same on every rank
    (sharded_gram.py:242-260)."""
    ax = _Axis(mesh, axis)
    L_local, nb = ax.rows(L)
    B = config.as_input(B, L_local.device).to(L_local.dtype)
    return _backward_solve(L_local, _forward_solve(L_local, B, ax, nb), ax, nb)


def fit_sharded(kernel, X, Y, sigma, mesh, axis: str = "data"):
    """(alpha, logdet, the rank's rows of L) of the GP fit K + sigma^2 I
    (sharded_gram.py:263-298): the route for an n whose K does not fit on
    one card.  X (n, d) and Y (n, q) or (n,) are given whole to every rank;
    n must be divisible by the mesh dimension's size.  The rank's block row
    of K is factored in place, and made again from X for a jitter try, so a
    rank holds one (n / D, n) block row and a few (n / D, n / D) blocks."""
    ax = _Axis(mesh, axis)
    X = config.as_input(X, mesh_device(mesh))
    Y = config.as_input(Y, X.device).to(X.dtype)
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] % ax.size:
        raise ValueError(f"n ({X.shape[0]}) must be divisible by mesh axis size ({ax.size})")
    nb = X.shape[0] // ax.size

    def fresh(jitter):
        K = sharded_gram(kernel, X, mesh, axis)
        _add_diag_(K, torch.as_tensor(sigma, dtype=K.dtype) ** 2, ax, nb)
        return K if jitter is None else _add_diag_(K, jitter, ax, nb)

    L, _ = _safe_chol(fresh, ax, nb, mesh, axis, 0.0, 6)
    alpha = cho_solve_sharded(L, Y, mesh, axis)
    diag = L[:, ax.rank * nb:(ax.rank + 1) * nb].diagonal()
    logdet = ax.all_reduce((2.0 * torch.log(diag).sum()).reshape(1))[0]
    return alpha, logdet, L
