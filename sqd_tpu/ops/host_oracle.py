# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Host-NumPy f64 reference for the device operator: matvec and energy.

Every contraction here runs in NumPy f64 on the host, from the operator's own
gather and neighbor tables, so it shares the tables with the device path but
none of its arithmetic: no XLA, no device matmul precision, no f32.  It is
the plain reference that device results at real sizes are checked against
(an f32 matvec that leaked into TF32 shows up as ~1e-3 relative error here,
and an energy that is off in the 8th digit shows up against
:func:`host_rayleigh_quotient`).  At 10^6 determinants (npair = 256) one
matvec is ~130 GFLOP of host BLAS and a few hundred MB of blocked
intermediates.
"""

from __future__ import annotations

import numpy as np

__all__ = ["host_matvec", "host_rayleigh_quotient"]


def _padded_amplitudes(ham, c) -> np.ndarray:
    """``c`` as an f64 ``ham.shape`` matrix; smaller inputs are zero-padded."""
    m, n = ham.shape
    c = np.asarray(c, np.float64)
    if c.ndim == 1:
        c = c.reshape(m, n)
    if c.shape != (m, n):
        c = np.pad(c, ((0, m - c.shape[0]), (0, n - c.shape[1])))
    return c


def _masked_neighbors(idx, val, size):
    """Neighbor tables with any out-of-range (sentinel) entry made inert."""
    idx = np.asarray(idx)
    val = np.asarray(val, np.float64)
    ok = idx < size
    return np.where(ok, idx, 0), np.where(ok, val, 0.0)


def host_matvec(ham, c, *, row_block: int = 64) -> np.ndarray:
    """``(P H P) c`` in NumPy f64 for an :class:`SCIHamiltonian` (bare H).

    ``c`` is the ``(M, N)`` amplitude matrix or its flat form; an unpadded
    ``(m, n)`` input is zero-padded to the operator's padded shape.  The
    cross-spin channel is blocked over ``row_block`` alpha rows to bound the
    ``(npair, row_block, N)`` intermediates.  The spin penalty is not
    applied: an operator with ``spin_shift != 0`` is refused.
    """
    if ham.spin_shift != 0.0:
        raise ValueError("host_matvec applies the bare Hamiltonian; spin_shift must be 0")
    c = _padded_amplitudes(ham, c)
    m, n = c.shape
    src_a = np.asarray(ham.src_a)
    sign_a = np.asarray(ham.sign_a, np.float64)
    src_b = np.asarray(ham.src_b)
    sign_b = np.asarray(ham.sign_b, np.float64)
    eri_t = np.asarray(ham.eri_t, np.float64)
    npair = eri_t.shape[0]
    idx_a, val_a = _masked_neighbors(ham.nbr_idx_a, ham.nbr_val_a, m)
    idx_b, val_b = _masked_neighbors(ham.nbr_idx_b, ham.nbr_val_b, n)
    sigma = np.zeros((m, n))
    for j0 in range(0, m, row_block):
        rows = slice(j0, min(j0 + row_block, m))
        # cross-spin: sigma[j, k] = sum_rs sign_b[rs, k] G[rs, j, src_b[rs, k]]
        # with G[rs] = sum_pq eri_t[rs, pq] (E^a_pq c)
        d_a = sign_a[:, rows, None] * c[src_a[:, rows]]  # (npair, bj, n)
        bj = d_a.shape[1]
        g = (eri_t @ d_a.reshape(npair, -1)).reshape(npair, bj, n)
        picked = np.take_along_axis(g, src_b[:, None, :], axis=2)
        sig = np.einsum("rk,rjk->jk", sign_b, picked)
        # same-spin channels (their neighbor lists hold the diagonal too)
        sig += np.einsum("jl,jln->jn", val_a[rows], c[idx_a[rows]])
        sig += np.einsum("kl,jkl->jk", val_b, c[rows][:, idx_b])
        sigma[rows] = sig
    return sigma


def host_rayleigh_quotient(ham, c) -> float:
    """``<c|H|c> / <c|c>`` in NumPy f64 (bare H, see :func:`host_matvec`)."""
    c = _padded_amplitudes(ham, c)
    return float(np.vdot(c, host_matvec(ham, c)) / np.vdot(c, c))
