# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Jitted Davidson eigensolver with fixed-shape workspaces.

Device replacement for PySCF's ``lib.davidson`` (reference SURVEY.md N2):
the whole iteration — matvec, Rayleigh-Ritz in the Krylov subspace,
diagonal preconditioning, Gram-Schmidt, thick restart — runs inside one
``lax.while_loop`` with static shapes, so XLA compiles a single program per
(subspace-dim, max-subspace) bucket and the device never round-trips to the
host mid-solve.

Design notes:
* The subspace basis ``V`` and its images ``W = H V`` are fixed ``(mss, dim)``
  buffers; an integer ``m`` tracks the active rows and masking handles the rest
  (no dynamic shapes anywhere).
* Rayleigh-Ritz uses an f64 ``jnp.linalg.eigh`` on the masked ``(mss, mss)``
  Gram matrix — tiny, so running it every iteration is free compared to a
  matvec.
* Restart is "thick": compress to the current best Ritz vector, keep its image,
  and continue — matching the memory profile PySCF achieves with max_space.
* The solver runs in the caller's dtype (f32 on the fast path); callers
  refine the final energy in f64 (see sqd_tpu.ops.rdm) — the Rayleigh
  quotient is second-order accurate in the residual, so an f32-converged
  vector already gives ~1e-10-relative energies in the f64 quotient.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "davidson_ground_state",
    "davidson_ground_state_segmented",
    "davidson_initial_guess",
    "davidson_initial_guess_k",
    "davidson_lowest_k",
    "DavidsonResult",
    "DavidsonKResult",
]


def davidson_initial_guess(hdiag: jax.Array, dtype=None) -> jax.Array:
    """Robust start vector: min-diagonal one-hot + a diagonal-weighted spread.

    A bare one-hot at ``argmin(hdiag)`` can be an exact eigenvector of a
    *disconnected* block of a selected-CI projected Hamiltonian, making
    Davidson terminate at a non-global eigenvalue.  Adding a small component
    on every determinant (decaying with the diagonal gap; negligible on
    huge-diagonal padding entries) guarantees overlap with the true ground
    state.
    """
    dtype = hdiag.dtype if dtype is None else dtype
    finite = jnp.where(jnp.abs(hdiag) > 1e20, jnp.inf, hdiag)
    lo = jnp.min(finite)
    spread = 1.0 / (finite - lo + 1.0)
    spread = spread / jnp.linalg.norm(spread)
    v0 = spread * 0.2
    v0 = v0.at[jnp.argmin(finite)].add(1.0)
    return v0.astype(dtype)


class DavidsonResult(NamedTuple):
    theta: jax.Array  # lowest Ritz value found
    vector: jax.Array  # (dim,) normalized Ritz vector
    residual_norm: jax.Array
    iterations: jax.Array
    converged: jax.Array


class DavidsonKResult(NamedTuple):
    thetas: jax.Array  # (k,) lowest Ritz values, ascending
    vectors: jax.Array  # (k, dim) normalized Ritz vectors
    residual_norms: jax.Array  # (k,)
    iterations: jax.Array
    converged: jax.Array  # all k residuals below tol


def davidson_initial_guess_k(hdiag: jax.Array, k: int, dtype=None) -> jax.Array:
    """(k, dim) start block: one-hots at the k smallest diagonal entries.

    Each row gets the same diagonal-weighted spread as
    :func:`davidson_initial_guess` so disconnected blocks cannot trap a Ritz
    pair; rows are linearly independent by construction (distinct spikes).
    """
    dtype = hdiag.dtype if dtype is None else dtype
    finite = jnp.where(jnp.abs(hdiag) > 1e20, jnp.inf, hdiag)
    lo = jnp.min(finite)
    spread = 1.0 / (finite - lo + 1.0)
    spread = spread / jnp.linalg.norm(spread)
    _, idx = jax.lax.top_k(-finite, k)
    block = jnp.tile(spread[None, :] * 0.2, (k, 1))
    return block.at[jnp.arange(k), idx].add(1.0).astype(dtype)


class _State(NamedTuple):
    v: jax.Array  # (mss, dim) basis
    w: jax.Array  # (mss, dim) H @ basis
    t: jax.Array  # (mss, mss) Gram matrix V H V^T
    m: jax.Array  # active subspace size
    theta: jax.Array
    u: jax.Array  # (dim,) current Ritz vector
    hu: jax.Array  # (dim,) H @ u
    rnorm: jax.Array
    it: jax.Array
    done: jax.Array


def _masked_eigh(t: jax.Array, m: jax.Array):
    """Eigendecomposition of the active m x m block of t (masked to mss).

    Inactive rows get a huge diagonal so their eigenpairs sort last; active
    eigenvectors have exact zeros in inactive rows.
    """
    mss = t.shape[0]
    idx = jnp.arange(mss)
    active = idx < m
    mask2 = active[:, None] & active[None, :]
    # The inactive diagonal only needs to dominate the active spectrum; a
    # huge constant (finfo.max-scale) overflows when squared inside eigh,
    # especially in f32 — scale off the actual Gram magnitude instead.
    big = (jnp.max(jnp.abs(t)) + 1.0) * 4.0
    t_masked = jnp.where(mask2, t, 0.0) + jnp.diag(jnp.where(active, 0.0, big))
    # The Gram matrix is tiny (mss x mss) but its eigensolve must be accurate
    # in 64-bit: an f32 eigh carries ~eps*|A| error that the sentinel scale
    # turns into O(1) garbage in the active block.
    wide = jnp.complex128 if jnp.iscomplexobj(t) else jnp.float64
    vals, vecs = jnp.linalg.eigh(t_masked.astype(wide))
    vals = vals.astype(jnp.finfo(t.dtype).dtype)
    vecs = (vecs * active[:, None]).astype(t.dtype)
    return vals, vecs


def _masked_eigh_min(t: jax.Array, m: jax.Array):
    vals, vecs = _masked_eigh(t, m)
    return vals[0], vecs[:, 0]


@partial(
    jax.jit, static_argnames=("matvec", "max_subspace", "max_iterations", "axis_name")
)
def davidson_ground_state(
    matvec: Callable,
    operator,
    hdiag: jax.Array,
    v0: jax.Array,
    *,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_iterations: int = 200,
    axis_name: str | None = None,
) -> DavidsonResult:
    """Find the lowest eigenpair of the implicit symmetric operator.

    Args:
        matvec: STATIC module-level function ``matvec(operator, x) -> Hx`` on
            flat (dim,) vectors.  Keeping it a stable function (not a closure)
            lets XLA reuse the compiled program across solves of the same
            shape — the operator data travels as the pytree argument.
        operator: pytree of device arrays consumed by ``matvec`` (e.g. an
            :class:`~sqd_tpu.ops.hamiltonian.SCIHamiltonian`).
        hdiag: (dim,) diagonal of H for the preconditioner; padded entries
            should hold a huge value so they are never selected or amplified.
        v0: (dim,) initial guess (need not be normalized).
        tol: residual-norm convergence threshold.
        max_subspace: Krylov buffer rows (static).
        max_iterations: matvec budget (static).
        axis_name: when set (inside ``shard_map``), vectors are the LOCAL
            shard of a dimension distributed over this mesh axis: every inner
            product / norm / Gram entry is completed with a ``lax.psum`` and
            the Krylov workspace stays sharded — this is what scales one
            solve's memory across chips (the matvec must consume/produce the
            same local shard layout).
    """
    # A reduced-precision f32 matmul (TF32 on the GPU, ~1e-3 relative error)
    # is fatal for Gram-Schmidt and the Rayleigh-Ritz Gram matrix. Force true
    # f32 products throughout the solver.
    with jax.default_matmul_precision("highest"):
        return _davidson_inner(
            matvec, operator, hdiag, v0,
            tol=tol, max_subspace=max_subspace, max_iterations=max_iterations,
            axis_name=axis_name,
        )


def _davidson_inner(
    matvec, operator, hdiag, v0, *, tol, max_subspace, max_iterations, axis_name=None
) -> DavidsonResult:
    dim = hdiag.shape[0]
    dt = v0.dtype
    mss = max_subspace
    eps = float(jnp.finfo(dt).tiny) ** 0.5  # real scalar also for complex dt

    if axis_name is None:
        _allsum = lambda x: x  # noqa: E731
    else:
        _allsum = partial(jax.lax.psum, axis_name=axis_name)

    def _vdot(a, b):
        return _allsum(jnp.vdot(a, b))

    def _norm(a):
        return jnp.sqrt(jnp.real(_allsum(jnp.vdot(a, a))))

    v0 = v0 / _norm(v0)
    w0 = matvec(operator, v0)
    v_buf = jnp.zeros((mss, dim), dt).at[0].set(v0)
    w_buf = jnp.zeros((mss, dim), dt).at[0].set(w0)
    t_buf = jnp.zeros((mss, mss), dt).at[0, 0].set(_vdot(v0, w0))
    theta0 = jnp.real(t_buf[0, 0]).astype(jnp.finfo(dt).dtype)
    r0 = w0 - theta0 * v0
    rnorm0 = _norm(r0)
    state = _State(
        v=v_buf,
        w=w_buf,
        t=t_buf,
        m=jnp.asarray(1),
        theta=theta0,
        u=v0,
        hu=w0,
        rnorm=rnorm0,
        it=jnp.asarray(0),
        done=rnorm0 < tol,
    )

    def precondition(r, theta):
        # Clamp scaled to the spectrum: the argmin-hdiag determinant sits at
        # |hdiag - theta| ~ 0, and an absolute micro-clamp would turn it into
        # a spike nearly parallel to the current Ritz vector — wasted (and in
        # f32, Gram-Schmidt-annihilated) amplification.  Capping at ~1e-3 of
        # the scale keeps the preconditioner a contraction toward other
        # determinants.
        clamp = 1e-3 * (1.0 + jnp.abs(theta))
        denom = hdiag - theta
        safe = jnp.where(denom == 0, 1.0, denom)
        denom = jnp.where(
            jnp.abs(denom) < clamp, jnp.where(safe < 0, -clamp, clamp), denom
        )
        return r / denom

    def orthonormalize(t_vec, v, m):
        """Two rounds of masked classical Gram-Schmidt; returns (vec, norm)."""
        active = (jnp.arange(mss) < m).astype(dt)
        for _ in range(2):
            coeffs = _allsum(v.conj() @ t_vec) * active
            t_vec = t_vec - v.T @ coeffs
        nrm = _norm(t_vec)
        return t_vec / jnp.maximum(nrm, eps), nrm

    def body(s: _State) -> _State:
        # residual of current best Ritz pair, preconditioned -> new direction
        r = s.hu - s.theta * s.u
        pre = precondition(r, s.theta)
        pre_norm = _norm(pre)
        t_pre, nrm_pre = orthonormalize(pre, s.v, s.m)
        # The clamped preconditioner can produce a spike that lies (almost)
        # inside the current subspace; after Gram-Schmidt the leftover is then
        # relatively tiny yet either meaningful or pure noise.  Fall back to
        # the raw residual direction in that case, and only stop (precision
        # floor) when that collapses too.
        dep_eps = 64 * jnp.finfo(jnp.finfo(dt).dtype).eps
        pre_dead = nrm_pre <= dep_eps * jnp.maximum(pre_norm, eps)
        # NOTE: computed unconditionally — a lax.cond here would make its
        # branches copy the big carried state; two extra GEMM rounds are
        # cheaper.
        t_raw, nrm_raw = orthonormalize(r, s.v, s.m)
        t_new = jnp.where(pre_dead, t_raw, t_pre)
        stalled = pre_dead & (nrm_raw <= dep_eps * jnp.maximum(s.rnorm, eps))

        def stalled_exit(s: _State) -> _State:
            return s._replace(it=s.it + 1, done=jnp.asarray(True))

        def expand(s: _State) -> _State:
            # thick restart when the buffer is full: keep the best few Ritz
            # vectors (a single-vector restart loses the subspace and stalls
            # on spectra with degenerate diagonals).
            keep = max(1, min(mss // 3, 8))

            def do_restart(s: _State) -> _State:
                vals, vecs = _masked_eigh(s.t, s.m)
                y = vecs[:, :keep]  # (mss, keep), inactive rows zero
                v = jnp.zeros_like(s.v).at[:keep].set(y.T @ s.v)
                w = jnp.zeros_like(s.w).at[:keep].set(y.T @ s.w)
                t = jnp.zeros_like(s.t).at[jnp.arange(keep), jnp.arange(keep)].set(
                    vals[:keep].astype(s.t.dtype)
                )
                return s._replace(v=v, w=w, t=t, m=jnp.asarray(keep))

            s = jax.lax.cond(s.m >= mss, do_restart, lambda x: x, s)
            # re-orthonormalize against (possibly restarted) basis
            t_ortho, _ = orthonormalize(t_new, s.v, s.m)

            w_new = matvec(operator, t_ortho)
            v = s.v.at[s.m].set(t_ortho)
            w = s.w.at[s.m].set(w_new)
            col = _allsum(v.conj() @ w_new) * (jnp.arange(mss) <= s.m)
            t = s.t.at[s.m, :].set(col.conj()).at[:, s.m].set(col)
            m = s.m + 1

            theta, y = _masked_eigh_min(t, m)
            u = y @ v
            hu = y @ w
            rnorm = _norm(hu - theta * u)
            return _State(
                v=v,
                w=w,
                t=t,
                m=m,
                theta=theta,
                u=u,
                hu=hu,
                rnorm=rnorm,
                it=s.it + 1,
                done=rnorm < tol,
            )

        return jax.lax.cond(stalled, stalled_exit, expand, s)

    def cond(s: _State):
        return (~s.done) & (s.it < max_iterations)

    final = jax.lax.while_loop(cond, body, state)
    u = final.u / _norm(final.u)
    return DavidsonResult(
        theta=final.theta,
        vector=u,
        residual_norm=final.rnorm,
        iterations=final.it,
        converged=final.done,
    )


def davidson_ground_state_segmented(
    matvec: Callable,
    operator,
    hdiag: jax.Array,
    v0: jax.Array,
    *,
    tol: float = 1e-5,
    max_subspace: int = 24,
    max_iterations: int = 200,
    segment_iterations: int = 25,
    axis_name: str | None = None,
) -> DavidsonResult:
    """Same contract as :func:`davidson_ground_state`, bounded device programs.

    Re-launches the jitted solver every ``segment_iterations`` matvecs,
    warm-starting from the current Ritz vector, so no single device program
    runs for the whole solve.  The host sync between segments costs one
    repeated matvec (v0 re-application), negligible against multi-second
    matvecs, and every segment reuses ONE compiled program (constant static
    bound).  The host sees progress between segments, at the price of a
    solve that restarts its Krylov space every segment.
    """
    total = 0
    v = v0
    res = None
    while total < max_iterations:
        res = davidson_ground_state(
            matvec, operator, hdiag, v,
            tol=tol, max_subspace=max_subspace,
            max_iterations=segment_iterations, axis_name=axis_name,
        )
        it = int(res.iterations)
        total += it
        # converged, stalled (precision floor), or solver exited early
        if bool(res.converged) or it < segment_iterations:
            break
        v = res.vector
    return res._replace(iterations=jnp.asarray(min(total, max_iterations)))


class _KState(NamedTuple):
    v: jax.Array  # (mss, dim) basis
    w: jax.Array  # (mss, dim) H @ basis
    t: jax.Array  # (mss, mss) Gram matrix
    m: jax.Array  # active subspace size
    thetas: jax.Array  # (k,) current Ritz values
    u: jax.Array  # (k, dim) Ritz vectors
    hu: jax.Array  # (k, dim) H @ u
    rnorms: jax.Array  # (k,)
    it: jax.Array
    done: jax.Array


@partial(
    jax.jit,
    static_argnames=("matvec", "k", "max_subspace", "max_iterations", "axis_name"),
)
def davidson_lowest_k(
    matvec: Callable,
    operator,
    hdiag: jax.Array,
    v0: jax.Array,
    *,
    k: int,
    tol: float = 1e-5,
    max_subspace: int = 32,
    max_iterations: int = 300,
    axis_name=None,
) -> DavidsonKResult:
    """Block Davidson: the k lowest eigenpairs of an implicit symmetric operator.

    Same contract as :func:`davidson_ground_state` generalized to a block —
    the device-side replacement for ``scipy.sparse.linalg.eigsh(..., k=k,
    which="SA")`` (reference ``qubit.py:73``) and the source of fermionic
    excited states.  ``v0`` is a ``(k, dim)`` start block (see
    :func:`davidson_initial_guess_k`); each iteration expands the shared
    Krylov space with the preconditioned residual of the lowest unconverged
    Ritz pair, and thick restarts always retain at least ``k + 2`` Ritz
    vectors, so converged pairs are never lost.
    """
    if k >= max_subspace - 2:
        raise ValueError(f"max_subspace ({max_subspace}) must exceed k + 2 ({k + 2})")
    with jax.default_matmul_precision("highest"):
        return _davidson_k_inner(
            matvec, operator, hdiag, v0,
            k=k, tol=tol, max_subspace=max_subspace,
            max_iterations=max_iterations, axis_name=axis_name,
        )


def _davidson_k_inner(
    matvec, operator, hdiag, v0, *, k, tol, max_subspace, max_iterations, axis_name
) -> DavidsonKResult:
    dim = hdiag.shape[0]
    dt = v0.dtype
    mss = max_subspace
    eps = float(jnp.finfo(dt).tiny) ** 0.5

    if axis_name is None:
        _allsum = lambda x: x  # noqa: E731
    else:
        _allsum = partial(jax.lax.psum, axis_name=axis_name)

    def _norm(a):
        return jnp.sqrt(jnp.real(_allsum(jnp.vdot(a, a))))

    def _row_norms(x):
        return jnp.sqrt(jnp.real(_allsum(jnp.sum(x * x.conj(), axis=1))))

    def orthonormalize(t_vec, v, m):
        active = (jnp.arange(mss) < m).astype(dt)
        for _ in range(2):
            coeffs = _allsum(v.conj() @ t_vec) * active
            t_vec = t_vec - v.T @ coeffs
        nrm = _norm(t_vec)
        return t_vec / jnp.maximum(nrm, eps), nrm

    # seed the basis with the orthonormalized start block (k matvecs)
    v_buf = jnp.zeros((mss, dim), dt)
    w_buf = jnp.zeros((mss, dim), dt)
    for i in range(k):
        row, _ = orthonormalize(v0[i], v_buf, jnp.asarray(i))
        v_buf = v_buf.at[i].set(row)
        w_buf = w_buf.at[i].set(matvec(operator, row))
    t_buf = jnp.zeros((mss, mss), dt)
    blk = _allsum(v_buf[:k].conj() @ w_buf[:k].T)
    blk = 0.5 * (blk + blk.conj().T)  # symmetrize roundoff
    t_buf = t_buf.at[:k, :k].set(blk)

    def ritz(v, w, t, m):
        vals, vecs = _masked_eigh(t, m)
        thetas = vals[:k]
        y = vecs[:, :k]  # (mss, k)
        u = y.T @ v
        hu = y.T @ w
        rnorms = _row_norms(hu - thetas[:, None] * u)
        return thetas, u, hu, rnorms

    thetas0, u0, hu0, rnorms0 = ritz(v_buf, w_buf, t_buf, jnp.asarray(k))
    state = _KState(
        v=v_buf, w=w_buf, t=t_buf, m=jnp.asarray(k),
        thetas=thetas0, u=u0, hu=hu0, rnorms=rnorms0,
        it=jnp.asarray(0), done=jnp.all(rnorms0 < tol),
    )

    def precondition(r, theta):
        clamp = 1e-3 * (1.0 + jnp.abs(theta))
        denom = hdiag - theta
        safe = jnp.where(denom == 0, 1.0, denom)
        denom = jnp.where(
            jnp.abs(denom) < clamp, jnp.where(safe < 0, -clamp, clamp), denom
        )
        return r / denom

    keep = min(max(k + 2, min(mss // 3, 8)), mss - 2)

    def body(s: _KState) -> _KState:
        # lowest unconverged Ritz pair drives the expansion
        unconv = s.rnorms >= tol
        pick = jnp.argmax(jnp.where(unconv, jnp.arange(k, 0, -1), 0))
        r = s.hu[pick] - s.thetas[pick] * s.u[pick]
        pre = precondition(r, s.thetas[pick])
        pre_norm = _norm(pre)
        t_pre, nrm_pre = orthonormalize(pre, s.v, s.m)
        dep_eps = 64 * jnp.finfo(jnp.finfo(dt).dtype).eps
        pre_dead = nrm_pre <= dep_eps * jnp.maximum(pre_norm, eps)
        t_raw, nrm_raw = orthonormalize(r, s.v, s.m)
        t_new = jnp.where(pre_dead, t_raw, t_pre)
        stalled = pre_dead & (nrm_raw <= dep_eps * jnp.maximum(s.rnorms[pick], eps))

        def stalled_exit(s: _KState) -> _KState:
            return s._replace(it=s.it + 1, done=jnp.asarray(True))

        def expand(s: _KState) -> _KState:
            def do_restart(s: _KState) -> _KState:
                vals, vecs = _masked_eigh(s.t, s.m)
                y = vecs[:, :keep]
                v = jnp.zeros_like(s.v).at[:keep].set(y.T @ s.v)
                w = jnp.zeros_like(s.w).at[:keep].set(y.T @ s.w)
                t = jnp.zeros_like(s.t).at[jnp.arange(keep), jnp.arange(keep)].set(
                    vals[:keep].astype(s.t.dtype)
                )
                return s._replace(v=v, w=w, t=t, m=jnp.asarray(keep))

            s = jax.lax.cond(s.m >= mss, do_restart, lambda x: x, s)
            t_ortho, _ = orthonormalize(t_new, s.v, s.m)
            w_new = matvec(operator, t_ortho)
            v = s.v.at[s.m].set(t_ortho)
            w = s.w.at[s.m].set(w_new)
            col = _allsum(v.conj() @ w_new) * (jnp.arange(mss) <= s.m)
            t = s.t.at[s.m, :].set(col.conj()).at[:, s.m].set(col)
            m = s.m + 1
            thetas, u, hu, rnorms = ritz(v, w, t, m)
            return _KState(
                v=v, w=w, t=t, m=m, thetas=thetas, u=u, hu=hu, rnorms=rnorms,
                it=s.it + 1, done=jnp.all(rnorms < tol),
            )

        return jax.lax.cond(stalled, stalled_exit, expand, s)

    def cond(s: _KState):
        return (~s.done) & (s.it < max_iterations)

    final = jax.lax.while_loop(cond, body, state)
    u = final.u / jnp.maximum(_row_norms(final.u), eps)[:, None]
    return DavidsonKResult(
        thetas=final.thetas,
        vectors=u,
        residual_norms=final.rnorms,
        iterations=final.it,
        converged=final.done & jnp.all(final.rnorms < tol),
    )
