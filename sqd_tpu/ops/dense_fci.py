# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Dense Slater-Condon oracle (NumPy, host, test/reference use only).

An *independent* implementation of the projected Hamiltonian over a fixed
(strs_a x strs_b) determinant basis, built by explicit second-quantized
operator application on Python integers.  It deliberately shares no code with
the device kernels in :mod:`sqd_tpu.ops.hamiltonian` — it is the oracle the
device path is validated against (the role PySCF's ``selected_ci`` plays for the
reference, cf. ``fermion.py:513-515``), exact to f64.

Scaling is O(dim^2 * norb^2); use only for small subspaces in tests.

Conventions (shared with the device kernels):

* A CI string is an integer whose bit ``p`` is the occupation of spatial
  orbital ``p``.
* A determinant ``(Ia, Ib)`` is ``a+_{a1}...a+_{ak} a+_{b1}...a+_{bm} |0>``
  with alpha creation operators first, each spin's orbitals ascending.
  Because physical operators conserve each spin's particle number in pairs,
  alpha/beta crossing signs cancel and each spin's parity is internal.
* ``eri[p,q,r,s]`` is the chemist-notation two-electron integral ``(pq|rs)``;
  ``H = sum_pq h_pq E_pq + 1/2 sum_pqrs (pq|rs) [E_pq E_rs - d_qr E_ps]``.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "apply_excitation_int",
    "build_dense_hamiltonian",
    "build_dense_s2",
    "dense_rdm1s",
    "dense_rdm12",
    "all_hamming_strings",
]


def apply_excitation_int(string: int, p: int, q: int) -> tuple[int, int]:
    """Apply ``a+_p a_q`` to a CI string.

    Returns ``(new_string, sign)`` with ``sign = 0`` if the result vanishes.
    """
    string = int(string)
    if not (string >> q) & 1:
        return 0, 0
    s1 = string & ~(1 << q)
    sign = (-1) ** bin(string & ((1 << q) - 1)).count("1")
    if (s1 >> p) & 1:
        return 0, 0
    sign *= (-1) ** bin(s1 & ((1 << p) - 1)).count("1")
    return s1 | (1 << p), sign


def _index_map(strs):
    return {int(s): i for i, s in enumerate(strs)}


def _single_excitation_matrix(strs, norb: int):
    """E_pq matrices for one spin sector: dict (p, q) -> dense (n, n)."""
    idx = _index_map(strs)
    n = len(strs)
    out = {}
    for p in range(norb):
        for q in range(norb):
            m = np.zeros((n, n))
            for i, s in enumerate(strs):
                t, sign = apply_excitation_int(int(s), p, q)
                if sign != 0 and t in idx:
                    m[idx[t], i] = sign
            out[(p, q)] = m
    return out


def _full_sector(strs, norb: int):
    """The complete Hamming sector containing ``strs`` + embedding indices."""
    nelec = bin(int(strs[0])).count("1")
    full = all_hamming_strings(norb, nelec)
    idx = _index_map(full)
    sel = np.array([idx[int(s)] for s in strs])
    return full, sel


def build_dense_hamiltonian(
    strs_a, strs_b, h1e: np.ndarray, eri: np.ndarray
) -> np.ndarray:
    """Dense projected Hamiltonian ``P H P`` over the (strs_a x strs_b) basis.

    Built over the *complete* Hamming sectors (where operator products close)
    and then projected onto the selected product basis — so selected-CI paths
    through intermediate strings outside the selected sets are included
    exactly.  Basis ordering: index = ia * len(strs_b) + ib (row-major over
    the amplitude matrix, matching ``SCIState.amplitudes``).
    """
    norb = h1e.shape[0]
    full_a, sel_a = _full_sector(strs_a, norb)
    full_b, sel_b = _full_sector(strs_b, norb)
    ea = _single_excitation_matrix(full_a, norb)
    eb = _single_excitation_matrix(full_b, norb)
    na, nb = len(full_a), len(full_b)
    ia_, ib_ = np.eye(na), np.eye(nb)

    def e_pq(p, q):
        return np.kron(ea[(p, q)], ib_) + np.kron(ia_, eb[(p, q)])

    dim = na * nb
    h = np.zeros((dim, dim))
    e_cache = {}
    for p in range(norb):
        for q in range(norb):
            e_cache[(p, q)] = e_pq(p, q)
            h += h1e[p, q] * e_cache[(p, q)]
    for p in range(norb):
        for q in range(norb):
            acc = np.zeros((dim, dim))
            for r in range(norb):
                for s in range(norb):
                    acc += eri[p, q, r, s] * e_cache[(r, s)]
            h += 0.5 * (e_cache[(p, q)] @ acc)
        for s in range(norb):
            corr = np.zeros((dim, dim))
            for q in range(norb):
                corr += eri[p, q, q, s] * e_cache[(p, s)]
            h -= 0.5 * corr
    # project onto the selected product basis
    keep = (sel_a[:, None] * nb + sel_b[None, :]).reshape(-1)
    return h[np.ix_(keep, keep)]


def build_dense_s2(strs_a, strs_b, norb: int) -> np.ndarray:
    """Dense total-spin-squared operator over the product basis.

    ``S^2 = Sz^2 + Sz + S- S+`` with
    ``S- S+ = N_b - sum_pq E^a_pq E^b_qp`` (alpha/beta E operators commute).
    """
    na_e = bin(int(strs_a[0])).count("1")
    nb_e = bin(int(strs_b[0])).count("1")
    sz = 0.5 * (na_e - nb_e)
    ea = _single_excitation_matrix(strs_a, norb)
    eb = _single_excitation_matrix(strs_b, norb)
    dim = len(strs_a) * len(strs_b)
    s2 = (sz * sz + sz + nb_e) * np.eye(dim)
    # The mixed term is a product of independent single-spin matrix elements
    # (no intermediate strings), so building on the selected sets is exact.
    for p in range(norb):
        for q in range(norb):
            s2 -= np.kron(ea[(p, q)], eb[(q, p)])
    return s2


def _embed(vec, strs_a, strs_b, norb):
    """Embed a selected-basis vector into the full-sector product basis."""
    full_a, sel_a = _full_sector(strs_a, norb)
    full_b, sel_b = _full_sector(strs_b, norb)
    c_full = np.zeros((len(full_a), len(full_b)))
    c_full[np.ix_(sel_a, sel_b)] = vec.reshape(len(strs_a), len(strs_b))
    return c_full, full_a, full_b


def dense_rdm1s(vec: np.ndarray, strs_a, strs_b, norb: int):
    """Spin-resolved 1-RDMs ``dm1[p, q] = <a+_p a_q>`` of a normalized vector."""
    c, full_a, full_b = _embed(vec, strs_a, strs_b, norb)
    ea = _single_excitation_matrix(full_a, norb)
    eb = _single_excitation_matrix(full_b, norb)
    dm_a = np.zeros((norb, norb))
    dm_b = np.zeros((norb, norb))
    for p in range(norb):
        for q in range(norb):
            dm_a[p, q] = np.sum(c * (ea[(p, q)] @ c))
            dm_b[p, q] = np.sum(c * (c @ eb[(p, q)].T))
    return dm_a, dm_b


def dense_rdm12(vec: np.ndarray, strs_a, strs_b, norb: int):
    """Spin-summed (dm1, dm2) with ``dm2[p,q,r,s] = <E_pq E_rs> - d_qr <E_ps>``.

    Computed in the full-sector embedding (operator products need
    out-of-subspace intermediates).  Satisfies
    ``E = sum h*dm1 + 1/2 sum (pq|rs) dm2[p,q,r,s]``.
    """
    c_mat, full_a, full_b = _embed(vec, strs_a, strs_b, norb)
    na, nb = len(full_a), len(full_b)
    c = c_mat.reshape(na * nb)
    ea = _single_excitation_matrix(full_a, norb)
    eb = _single_excitation_matrix(full_b, norb)
    ia_, ib_ = np.eye(na), np.eye(nb)
    e = {
        (p, q): np.kron(ea[(p, q)], ib_) + np.kron(ia_, eb[(p, q)])
        for p in range(norb)
        for q in range(norb)
    }
    dm1 = np.zeros((norb, norb))
    for p in range(norb):
        for q in range(norb):
            dm1[p, q] = c @ (e[(p, q)] @ c)
    dm2 = np.zeros((norb,) * 4)
    ec = {k: m @ c for k, m in e.items()}
    for p in range(norb):
        for q in range(norb):
            for r in range(norb):
                for s in range(norb):
                    dm2[p, q, r, s] = ec[(q, p)] @ ec[(r, s)]
                    if q == r:
                        dm2[p, q, r, s] -= dm1[p, s]
    return dm1, dm2


def all_hamming_strings(norb: int, nelec: int) -> np.ndarray:
    """All CI strings of ``norb`` orbitals with ``nelec`` electrons, ascending."""
    from itertools import combinations

    out = []
    for occ in combinations(range(norb), nelec):
        v = 0
        for p in occ:
            v |= 1 << p
        out.append(v)
    return np.array(sorted(out), dtype=np.int64 if norb < 63 else object)
