# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Core engine validation: gather-table matvec / Davidson / RDMs vs dense oracle.

The oracle (sqd_tpu.ops.dense_fci) is an independent NumPy Slater-Condon
implementation — exactly the role PySCF plays for the reference tests.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from sqd_tpu.ops import bitpack, dense_fci, rdm
from sqd_tpu.ops.davidson import davidson_ground_state
from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian


def random_integrals(norb, seed=0):
    """Random symmetric h1e and 8-fold-symmetric eri."""
    rng = np.random.default_rng(seed)
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    eri = rng.normal(size=(norb,) * 4) * 0.3
    eri = eri + eri.transpose(1, 0, 2, 3)
    eri = eri + eri.transpose(0, 1, 3, 2)
    eri = eri + eri.transpose(2, 3, 0, 1)
    return h1, eri / 8


def subspace(norb, na, nb, ka, kb, seed=1):
    """Random selected subsets of CI strings (sorted)."""
    rng = np.random.default_rng(seed)
    all_a = dense_fci.all_hamming_strings(norb, na)
    all_b = dense_fci.all_hamming_strings(norb, nb)
    strs_a = np.sort(rng.choice(all_a, size=min(ka, len(all_a)), replace=False))
    strs_b = np.sort(rng.choice(all_b, size=min(kb, len(all_b)), replace=False))
    return strs_a, strs_b


def build_pair(norb, na, nb, ka, kb, seed=0, **kw):
    h1, eri = random_integrals(norb, seed)
    strs_a, strs_b = subspace(norb, na, nb, ka, kb, seed + 1)
    pa = bitpack.pack_ints(strs_a, norb)
    pb = bitpack.pack_ints(strs_b, norb)
    ham = build_sci_hamiltonian(pa, pb, h1, eri, norb, (na, nb), **kw)
    h_dense = dense_fci.build_dense_hamiltonian(strs_a, strs_b, h1, eri)
    return ham, h_dense, (strs_a, strs_b, h1, eri)


@pytest.mark.parametrize(
    "norb,na,nb,ka,kb",
    [(4, 2, 2, 4, 4), (4, 2, 1, 5, 3), (5, 3, 2, 7, 6), (6, 2, 4, 8, 9)],
)
def test_matvec_matches_dense(norb, na, nb, ka, kb):
    ham, h_dense, _ = build_pair(norb, na, nb, ka, kb)
    m, n = ham.shape
    dim = m * n
    rng = np.random.default_rng(7)
    for _ in range(3):
        v = rng.normal(size=(m, n))
        sigma = np.asarray(ham.matvec(jnp.asarray(v)))
        expected = (h_dense @ v.reshape(-1)).reshape(m, n)
        np.testing.assert_allclose(sigma, expected, atol=1e-10)
    # hdiag
    np.testing.assert_allclose(
        np.asarray(ham.hdiag).reshape(-1), np.diagonal(h_dense), atol=1e-10
    )


def test_matvec_multiword_strings():
    """>32 orbitals forces 2-word packed strings through the whole path.

    Uses (1, 1) electrons so the oracle's full sector stays small; multiword
    double-excitation parities are covered by test_multiword_double_values.
    """
    norb, na, nb = 34, 1, 1
    rng = np.random.default_rng(3)
    strs = np.array(sorted({1 << p for p in [0, 1, 5, 12, 20, 31, 32, 33]}), dtype=object)
    h1, eri = random_integrals(norb, 5)
    pa = bitpack.pack_ints(strs, norb)
    ham = build_sci_hamiltonian(pa, pa, h1, eri, norb, (na, nb))
    # analytic two-particle (1 alpha, 1 beta) Hamiltonian:
    # H[(p',q'),(p,q)] = h[p',p] d_q'q + d_p'p h[q',q] + (p'p|q'q)
    orbs = [int(s).bit_length() - 1 for s in strs]
    m = len(strs)
    h_dense = np.zeros((m * m, m * m))
    for i1, p1 in enumerate(orbs):
        for j1, q1 in enumerate(orbs):
            for i2, p2 in enumerate(orbs):
                for j2, q2 in enumerate(orbs):
                    val = eri[p1, p2, q1, q2]
                    if q1 == q2:
                        val += h1[p1, p2]
                    if p1 == p2:
                        val += h1[q1, q2]
                    h_dense[i1 * m + j1, i2 * m + j2] = val
    v = rng.normal(size=(m, m))
    np.testing.assert_allclose(
        np.asarray(ham.matvec(jnp.asarray(v))),
        (h_dense @ v.reshape(-1)).reshape(m, m),
        atol=1e-10,
    )


def test_multiword_double_values():
    """Same-spin double-excitation Slater-Condon values across the word boundary.

    Independent check: compose a+_p a+_r a_s a_q with Python-int arithmetic
    (dense_fci.apply_excitation_int-style parities) and compare against the
    device neighbor-table values for norb = 34.
    """
    from sqd_tpu.ops.hamiltonian import build_samespin_tables

    norb, na = 34, 3
    h1, eri = random_integrals(norb, 11)
    # two strings connected by a cross-word double excitation, plus a third
    strs = np.array(
        sorted({(1 << 0) | (1 << 1) | (1 << 33), (1 << 5) | (1 << 32) | (1 << 33),
                (1 << 0) | (1 << 5) | (1 << 32)}),
        dtype=object,
    )
    pa = bitpack.pack_ints(strs, norb)
    idx, val = build_samespin_tables(pa, jnp.asarray(h1), jnp.asarray(eri), norb, na)
    idx, val = np.asarray(idx), np.asarray(val)

    def op4_sign(i, p, r, s, q):
        """Sign of a+_p a+_r a_s a_q |i> (0 if it vanishes)."""
        x, total = int(i), 0
        for orb, create in ((q, False), (s, False), (r, True), (p, True)):
            occ = (x >> orb) & 1
            if occ == (1 if create else 0):
                return 0
            total += bin(x & ((1 << orb) - 1)).count("1")
            x ^= 1 << orb
        return (-1) ** total, x

    # brute-force H_ss matrix over the three strings
    n = len(strs)
    h_ss = np.zeros((n, n))
    lookup = {int(s): i for i, s in enumerate(strs)}
    for ii, i_str in enumerate(strs):
        occ = [p for p in range(norb) if (int(i_str) >> p) & 1]
        # one-body + singles/diagonal via E_pq
        for p in range(norb):
            for q in occ:
                t, sg = dense_fci.apply_excitation_int(int(i_str), p, q)
                if sg and t in lookup:
                    h_ss[lookup[t], ii] += sg * h1[p, q]
        # two-body 1/2 (pq|rs) a+p a+r a_s a_q
        for p in range(norb):
            for r in range(norb):
                for s in occ:
                    for q in occ:
                        res = op4_sign(int(i_str), p, r, s, q)
                        if res == 0:
                            continue
                        sg, t = res
                        if t in lookup:
                            h_ss[lookup[t], ii] += 0.5 * eri[p, q, r, s] * sg
    # reconstruct the same matrix from the neighbor tables
    h_tab = np.zeros((n, n))
    for j in range(n):
        for l in range(idx.shape[1]):
            if idx[j, l] < n:
                h_tab[j, idx[j, l]] += val[j, l]
    np.testing.assert_allclose(h_tab, h_ss, atol=1e-10)


def test_padding_is_inert():
    ham, h_dense, _ = build_pair(4, 2, 2, 5, 4, seed=2)
    m, n = ham.shape
    ham_pad, _, _ = build_pair(4, 2, 2, 5, 4, seed=2, pad_to=(8, 8))
    rng = np.random.default_rng(0)
    v = rng.normal(size=(m, n))
    v_pad = np.zeros((8, 8))
    v_pad[:m, :n] = v
    sig = np.asarray(ham.matvec(jnp.asarray(v)))
    sig_pad = np.asarray(ham_pad.matvec(jnp.asarray(v_pad)))
    np.testing.assert_allclose(sig_pad[:m, :n], sig, atol=1e-12)
    assert np.all(sig_pad[m:, :] == 0) and np.all(sig_pad[:, n:] == 0)


@pytest.mark.parametrize("n", [8, 17, 24])
def test_masked_eigh_matches_numpy(n):
    """The Rayleigh-Ritz eigensolve of the masked Gram matrix vs LAPACK.

    Only the leading ``m`` rows/columns are active; the sentinel diagonal
    must sort the inactive pairs last and leave exact zeros in the inactive
    rows of the active eigenvectors."""
    from sqd_tpu.ops.davidson import _masked_eigh

    rng = np.random.default_rng(9 + n)
    a = rng.normal(size=(n, n))
    a = (a + a.T) / 2
    m = n - 3
    for dtype in (np.float64, np.float32):
        vals, vecs = _masked_eigh(jnp.asarray(a, dtype), jnp.asarray(m))
        vals, vecs = np.asarray(vals), np.asarray(vecs)
        assert vals.dtype == dtype and vecs.dtype == dtype
        ref_vals, ref_vecs = np.linalg.eigh(a[:m, :m])
        tol = 1e-10 if dtype == np.float64 else 1e-5
        np.testing.assert_allclose(vals[:m], ref_vals, atol=tol)
        # sentinel eigenvalues dominate the whole active spectrum
        assert np.all(vals[m:] > ref_vals.max())
        assert np.all(vecs[m:, :] == 0)
        # eigenvectors agree up to sign
        overlap = np.abs(np.sum(vecs[:m, :m] * ref_vecs, axis=0))
        np.testing.assert_allclose(overlap, 1.0, atol=tol)


def test_davidson_vs_eigh():
    from sqd_tpu.ops.hamiltonian import sci_matvec_flat

    ham, h_dense, _ = build_pair(5, 2, 3, 8, 7, seed=4)
    evals, evecs = np.linalg.eigh(h_dense)
    m, n = ham.shape
    hd = ham.hdiag.reshape(-1)
    v0 = jnp.zeros(m * n).at[jnp.argmin(hd)].set(1.0)
    res = davidson_ground_state(
        sci_matvec_flat, ham, hd, v0, tol=1e-9, max_subspace=16, max_iterations=150
    )
    assert bool(res.converged)
    np.testing.assert_allclose(float(res.theta), evals[0], atol=1e-8)
    overlap = abs(np.dot(np.asarray(res.vector), evecs[:, 0]))
    assert overlap > 1 - 1e-8


def test_davidson_f32_plus_f64_rayleigh():
    """Mixed precision: f32 iterations, f64 Rayleigh quotient -> ~1e-9 accuracy."""
    from sqd_tpu.ops.hamiltonian import sci_matvec_flat

    ham, h_dense, _ = build_pair(5, 3, 2, 9, 8, seed=6)
    evals, _ = np.linalg.eigh(h_dense)
    m, n = ham.shape
    hd = ham.hdiag.reshape(-1).astype(jnp.float32)
    v0 = jnp.zeros(m * n, jnp.float32).at[jnp.argmin(hd)].set(1.0)
    res = davidson_ground_state(
        sci_matvec_flat, ham, hd, v0, tol=2e-5, max_subspace=16, max_iterations=200
    )
    v64 = jnp.asarray(np.asarray(res.vector), jnp.float64)
    v64 = v64 / jnp.linalg.norm(v64)
    rq = float(jnp.vdot(v64, ham.matvec(v64.reshape(m, n)).reshape(-1)))
    assert abs(rq - evals[0]) < 5e-8


def test_f32_solve_with_f64_refinement_hits_1e8():
    """BASELINE accuracy target: f32 iterations + f64 refinement < 1e-8 Ha."""
    from sqd_tpu import fermion

    norb, nelec = 6, (3, 3)
    h1, eri = random_integrals(norb, seed=13)
    strs_a, strs_b = subspace(norb, 3, 3, 18, 16, seed=14)
    h_dense = dense_fci.build_dense_hamiltonian(strs_a, strs_b, h1, eri)
    e_exact = np.linalg.eigh(h_dense)[0][0]
    res32 = fermion.solve_sci(
        (strs_a, strs_b), h1, eri, norb=norb, nelec=nelec,
        solver_dtype=jnp.float32, tol=1e-4,
    )
    res_ref = fermion.solve_sci(
        (strs_a, strs_b), h1, eri, norb=norb, nelec=nelec,
        solver_dtype=jnp.float32, tol=1e-4, refine_iterations=10,
    )
    assert abs(res_ref.energy - e_exact) < 1e-8
    assert abs(res_ref.energy - e_exact) <= abs(res32.energy - e_exact) + 1e-12


def test_rdms_vs_oracle():
    ham, h_dense, (strs_a, strs_b, h1, eri) = build_pair(4, 2, 2, 5, 5, seed=8)
    evals, evecs = np.linalg.eigh(h_dense)
    gs = evecs[:, 0]
    m, n = ham.shape
    c = jnp.asarray(gs.reshape(m, n))
    dm1a, dm1b = rdm.rdm1s(ham, c)
    o_dm1a, o_dm1b = dense_fci.dense_rdm1s(gs, strs_a, strs_b, 4)
    np.testing.assert_allclose(np.asarray(dm1a), o_dm1a, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dm1b), o_dm1b, atol=1e-10)

    pa = bitpack.pack_ints(strs_a, 4)
    pb = bitpack.pack_ints(strs_b, 4)
    dm2 = rdm.rdm2_spin_summed(ham, c, pa, pb)
    o_dm1, o_dm2 = dense_fci.dense_rdm12(gs, strs_a, strs_b, 4)
    np.testing.assert_allclose(np.asarray(dm1a + dm1b), o_dm1, atol=1e-10)
    np.testing.assert_allclose(np.asarray(dm2), o_dm2, atol=1e-9)

    e = float(rdm.energy_from_rdms(h1, eri, dm1a + dm1b, dm2))
    assert abs(e - evals[0]) < 1e-9

    # spin-resolved consistency: dm2 == dm2aa + dm2bb + dm2ab + dm2ab^T(pq<->rs)
    dm2aa, dm2ab, dm2bb = rdm.rdm2s(ham, c, pa, pb)
    recon = (
        np.asarray(dm2aa)
        + np.asarray(dm2bb)
        + np.asarray(dm2ab)
        + np.asarray(dm2ab).transpose(2, 3, 0, 1)
    )
    np.testing.assert_allclose(recon, np.asarray(dm2), atol=1e-9)


def test_expectation_value_matches_matvec():
    """f64 <c|H|c>/<c|c> == the f64 matvec Rayleigh quotient, any input dtype.

    An f32 operator and an f32 vector are promoted to f64 before the matvec,
    so the quotient is exact to f64 roundoff either way."""
    from sqd_tpu.ops.hamiltonian import expectation_value, sci_matvec_flat

    ham, _, _ = build_pair(6, 3, 2, 17, 13, seed=31)
    m, n = ham.shape
    rng = np.random.default_rng(32)
    for dtype in (np.float64, np.float32):
        v = jnp.asarray(rng.normal(size=(m * n,)), dtype)
        v64 = v.astype(jnp.float64)
        hv = sci_matvec_flat(ham, v64)
        e_ref = float(jnp.vdot(v64, hv) / jnp.vdot(v64, v64))
        e = float(expectation_value(ham, v))
        assert abs(e - e_ref) < 1e-11 * max(1.0, abs(e_ref)), (dtype, e, e_ref)
    # an f32 operator's values are promoted: the quotient matches the f32
    # operator's own f64 matvec exactly
    ham32 = ham.astype(jnp.float32)
    v = jnp.asarray(rng.normal(size=(m * n,)))
    hv = sci_matvec_flat(ham32.astype(jnp.float64), v)
    e_ref = float(jnp.vdot(v, hv) / jnp.vdot(v, v))
    assert abs(float(expectation_value(ham32, v)) - e_ref) < 1e-11 * max(1.0, abs(e_ref))

    # spin penalty on/off
    h1, eri = random_integrals(4, 33)
    strs = dense_fci.all_hamming_strings(4, 2)
    pa4 = bitpack.pack_ints(strs, 4)
    ham_pen = build_sci_hamiltonian(
        pa4, pa4, h1, eri, 4, (2, 2), spin_shift=0.3, spin_target=2.0
    )
    v = jnp.asarray(rng.normal(size=(len(strs) ** 2,)))
    hv = sci_matvec_flat(ham_pen, v)
    e_pen_ref = float(jnp.vdot(v, hv) / jnp.vdot(v, v))
    tol = 1e-11
    e_pen = float(expectation_value(ham_pen, v))
    assert abs(e_pen - e_pen_ref) < tol * max(1.0, abs(e_pen_ref))
    # bare energy: subtract shift * (<S^2> - target)
    s2 = float(ham_pen.spin_square(v.reshape(len(strs), len(strs))))
    e_bare_ref = e_pen_ref - 0.3 * (s2 - 2.0)
    e_bare = float(expectation_value(ham_pen, v, spin_penalty=False))
    assert abs(e_bare - e_bare_ref) < tol * max(1.0, abs(e_bare_ref))


def test_rdms_blocked_matches_unblocked():
    """block_bytes=0 forces the smallest Gram tiles; results must be exact.

    Odd (13, 11) shape also exercises the zero-pad path (13 % 8 != 0)."""
    ham, _, (strs_a, strs_b, h1, eri) = build_pair(6, 3, 2, 13, 11, seed=21)
    m, n = ham.shape
    rng = np.random.default_rng(22)
    c = jnp.asarray(rng.normal(size=(m, n)))
    pa = bitpack.pack_ints(strs_a, 6)
    pb = bitpack.pack_ints(strs_b, 6)
    full = rdm.make_rdms(ham, c, pa, pb, spin_resolved=True)
    blk = rdm.make_rdms(ham, c, pa, pb, spin_resolved=True, block_bytes=0)
    for k in ("dm1a", "dm1b", "dm2aa", "dm2ab", "dm2bb"):
        np.testing.assert_allclose(np.asarray(blk[k]), np.asarray(full[k]), atol=1e-13)


def test_spin_square_and_penalty():
    norb, na, nb = 4, 2, 2
    h1, eri = random_integrals(norb, 9)
    strs = dense_fci.all_hamming_strings(norb, 2)  # full sector
    pa = bitpack.pack_ints(strs, norb)
    ham = build_sci_hamiltonian(pa, pa, h1, eri, norb, (na, nb))
    s2_dense = dense_fci.build_dense_s2(strs, strs, norb)
    m = len(strs)
    rng = np.random.default_rng(1)
    v = rng.normal(size=(m, m))
    # operator action check
    d_a = ham.gather_alpha(jnp.asarray(v))
    s2v = np.asarray(ham.s2_apply_from_alpha(d_a, jnp.asarray(v)))
    np.testing.assert_allclose(s2v, (s2_dense @ v.reshape(-1)).reshape(m, m), atol=1e-10)
    # expectation value
    val = float(ham.spin_square(jnp.asarray(v)))
    expected = v.reshape(-1) @ s2_dense @ v.reshape(-1) / (v.reshape(-1) @ v.reshape(-1))
    np.testing.assert_allclose(val, expected, atol=1e-10)
    # penalty-fused matvec == H v + shift*(S2 - ss) v
    ham_pen = build_sci_hamiltonian(
        pa, pa, h1, eri, norb, (na, nb), spin_shift=0.3, spin_target=2.0
    )
    h_dense = dense_fci.build_dense_hamiltonian(strs, strs, h1, eri)
    expected_pen = (
        h_dense @ v.reshape(-1) + 0.3 * (s2_dense @ v.reshape(-1) - 2.0 * v.reshape(-1))
    ).reshape(m, m)
    np.testing.assert_allclose(np.asarray(ham_pen.matvec(jnp.asarray(v))), expected_pen, atol=1e-10)


def test_solve_sci_excited_k3_vs_dense():
    """k=3 fermionic excited states pinned against the dense oracle (VERDICT r2 #7)."""
    import jax.numpy as jnp

    from sqd_tpu.fermion import solve_sci_excited
    from sqd_tpu.ops import dense_fci

    rng = np.random.default_rng(41)
    norb = 6
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    L = rng.normal(size=(12, norb, norb)) * 0.3
    L = (L + L.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", L, L)
    all_strs = dense_fci.all_hamming_strings(norb, 3)
    sel = np.sort(rng.choice(all_strs, 12, replace=False))
    results = solve_sci_excited((sel, sel), h1, eri, norb, (3, 3), k=3, tol=1e-9)
    h_dense = dense_fci.build_dense_hamiltonian(sel, sel, h1, eri)
    w = np.linalg.eigvalsh(h_dense)
    got = [r.energy for r in results]
    np.testing.assert_allclose(got, w[:3], atol=1e-8)
    # occupancies of each state sum to the electron counts
    for r in results:
        occ_a, occ_b = r.orbital_occupancies
        assert abs(occ_a.sum() - 3) < 1e-8 and abs(occ_b.sum() - 3) < 1e-8


def test_blocked_beta_first_variants_match_full():
    """Both beta-first blocked matvecs == the full path (incl. spin penalty).

    These are the 1e7-determinant strategies (dispatched when the G buffer
    exceeds 4 GB); on small problems they are reached directly here.
    """
    import jax.numpy as jnp

    from sqd_tpu.ops import bitpack
    from sqd_tpu.ops.dense_fci import all_hamming_strings
    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian

    rng = np.random.default_rng(51)
    norb, ne = 6, 3
    h1 = rng.normal(size=(norb, norb))
    h1 = (h1 + h1.T) / 2
    L = rng.normal(size=(12, norb, norb)) * 0.3
    L = (L + L.transpose(0, 2, 1)) / 2
    eri = np.einsum("xpq,xrs->pqrs", L, L)
    all_strs = all_hamming_strings(norb, ne)
    sel_a = np.sort(rng.choice(all_strs, 14, replace=False))
    sel_b = np.sort(rng.choice(all_strs, 16, replace=False))
    pa = bitpack.pack_ints(sel_a, norb)
    pb = bitpack.pack_ints(sel_b, norb)
    for spin_shift in (0.0, 0.3):
        ham = build_sci_hamiltonian(
            pa, pb, h1, eri, norb, (ne, ne),
            spin_shift=spin_shift, spin_target=0.0,
            dtype=jnp.float64, pad_to=None, col_block=4,
        )
        c = jnp.asarray(rng.normal(size=ham.shape))
        ref = ham._matvec_full(c)
        out_old = ham._SCIHamiltonian__matvec_blocked_beta_first(c)
        out_new = ham._SCIHamiltonian__matvec_blocked_beta_first_rowmajor(c)
        np.testing.assert_allclose(np.asarray(out_old), np.asarray(ref), atol=1e-10)
        np.testing.assert_allclose(np.asarray(out_new), np.asarray(ref), atol=1e-10)


def test_hdiag_device_matches_host():
    """Device-assembled diagonal == host f64 oracle (rank-structured pieces).

    The native build ships only O((M+N)*norb) operands above
    DEVICE_DIAG_MIN_ELEMS and assembles the (M, N) diagonal on device with
    elementwise f64 ops.
    """
    import jax.numpy as jnp

    from sqd_tpu.ops.hamiltonian import (
        _hdiag_device,
        _hdiag_np,
        _hdiag_parts_np,
        _occupancy_np,
    )

    norb = 7
    h1, eri = random_integrals(norb, 11)
    strs_a, strs_b = subspace(norb, 3, 2, 12, 9, 13)
    occ_a = _occupancy_np(bitpack.pack_ints(strs_a, norb), norb)
    occ_b = _occupancy_np(bitpack.pack_ints(strs_b, norb), norb)
    want = _hdiag_np(occ_a, occ_b, h1, eri)
    a_part, b_part, w = _hdiag_parts_np(occ_a, occ_b, h1, eri)
    got = _hdiag_device(
        jnp.asarray(a_part), jnp.asarray(b_part),
        jnp.asarray(occ_a), jnp.asarray(w), out_dtype=np.dtype(np.float64),
    )
    np.testing.assert_allclose(np.asarray(got), want, rtol=0, atol=1e-12)


def test_build_device_diag_path(monkeypatch):
    """Full native build through the device-diag branch == host-diag build."""
    import sqd_tpu.ops.hamiltonian as H
    from sqd_tpu import native

    if not native.available():
        pytest.skip("native table backend unavailable")
    ham_host, h_dense, (strs_a, strs_b, h1, eri) = build_pair(
        5, 3, 2, 7, 6, pad_to=(8, 8)
    )
    monkeypatch.setattr(H, "DEVICE_DIAG_MIN_ELEMS", 0)
    ham_dev, _, _ = build_pair(5, 3, 2, 7, 6, pad_to=(8, 8))
    hd_host = np.asarray(ham_host.hdiag)
    hd_dev = np.asarray(ham_dev.hdiag)
    m, n = len(strs_a), len(strs_b)
    np.testing.assert_allclose(hd_dev[:m, :n], hd_host[:m, :n], rtol=0, atol=1e-12)
    # padded entries stay inert (huge) in both builds
    assert np.all(hd_dev[m:, :] >= 1e29) and np.all(hd_dev[:, n:] >= 1e29)
    v = np.random.default_rng(3).normal(size=(m, n))
    vp = np.zeros(ham_dev.shape)
    vp[:m, :n] = v
    sigma = np.asarray(ham_dev.matvec(jnp.asarray(vp)))[:m, :n]
    np.testing.assert_allclose(
        sigma, (h_dense @ v.reshape(-1)).reshape(m, n), atol=1e-10
    )
