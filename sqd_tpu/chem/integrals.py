# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Molecular integrals over contracted Cartesian Gaussians (McMurchie-Davidson).

A minimal, self-contained Gaussian-integral engine (NumPy, host-side): overlap,
kinetic, nuclear-attraction and electron-repulsion integrals via the
McMurchie-Davidson scheme (Hermite expansion coefficients + Hermite Coulomb
integrals on Boys functions).  It exists so the framework can be validated on
*real molecules* end-to-end without PySCF in the image — the reference's
guides all start from ``pyscf.gto.M(...)`` (e.g.
``/root/reference/docs/guides/quickstart.ipynb`` cell 2); here
:class:`Molecule` + :func:`ao_integrals` play that role.

Correctness is pinned by reproducing the reference's published energies
(see :mod:`sqd_tpu.chem.basis_data`); everything here is plain f64 NumPy —
these matrices are tiny (``nao <= O(100)``), the device does the CI work.

Conventions: Cartesian p components ordered (x, y, z); ERI returned in
chemist notation ``(pq|rs)`` as a full 4-index tensor.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
from scipy.special import hyp1f1

from .basis_data import BASIS_SETS, ELEMENT_Z

__all__ = ["Molecule", "Shell", "ao_integrals", "nuclear_repulsion"]

BOHR_PER_ANGSTROM = 1.0 / 0.52917721092  # pyscf's Bohr radius (CODATA 2010)

_DFACT = {-1: 1.0, 0: 1.0, 1: 1.0, 2: 2.0, 3: 3.0, 4: 8.0, 5: 15.0}

# Cartesian component exponent triples per angular momentum
_CART = {
    0: [(0, 0, 0)],
    1: [(1, 0, 0), (0, 1, 0), (0, 0, 1)],
    2: [(2, 0, 0), (1, 1, 0), (1, 0, 1), (0, 2, 0), (0, 1, 1), (0, 0, 2)],
}

_SQRT3 = np.sqrt(3.0)

# Cartesian -> real-solid-harmonic transform, rows m = (-l..l), cols in _CART
# order.  Coefficients assume every Cartesian component carries the (l,0,0)
# normalization (exactly what Molecule.__post_init__ produces): with
# <xx|xx> = 1 and <xy|xy> = 1/3, each row below is unit-normalized, so the
# spherical AO overlap has a unit diagonal (pinned in tests/test_chem_d.py).
_C2S = {
    0: np.eye(1),
    1: np.eye(3),
    2: np.array(
        [
            [0.0, _SQRT3, 0.0, 0.0, 0.0, 0.0],  # d_{-2} ~ xy
            [0.0, 0.0, 0.0, 0.0, _SQRT3, 0.0],  # d_{-1} ~ yz
            [-0.5, 0.0, 0.0, -0.5, 0.0, 1.0],  # d_0 ~ (2z^2 - x^2 - y^2)/2
            [0.0, 0.0, _SQRT3, 0.0, 0.0, 0.0],  # d_{+1} ~ xz
            [_SQRT3 / 2, 0.0, 0.0, -_SQRT3 / 2, 0.0, 0.0],  # d_{+2} ~ x^2-y^2
        ]
    ),
}


@dataclass(frozen=True)
class Shell:
    """One contracted shell: angular momentum, center, primitives."""

    l: int
    center: np.ndarray  # (3,) bohr
    exps: np.ndarray  # (K,)
    coefs: np.ndarray  # (K,) — primitive norms and contraction norm folded in

    @property
    def ncomp(self) -> int:
        """Cartesian component count (the engine's internal working basis)."""
        return len(_CART[self.l])

    @property
    def nsph(self) -> int:
        """Real-solid-harmonic component count (the emitted AO basis)."""
        return 2 * self.l + 1


def _prim_norm(a: np.ndarray, l: int) -> np.ndarray:
    """Norm of the (l, 0, 0) Cartesian primitive Gaussian."""
    return (2.0 * a / np.pi) ** 0.75 * (4.0 * a) ** (l / 2.0) / np.sqrt(_DFACT[2 * l - 1])


@dataclass
class Molecule:
    """Geometry + basis; the ``pyscf.gto.M`` stand-in for this framework.

    Args:
        atoms: list of ``(symbol, (x, y, z))``.
        basis: basis-set name from :data:`sqd_tpu.chem.basis_data.BASIS_SETS`.
        unit: coordinate unit of the input geometry.
        charge: total molecular charge.
    """

    atoms: list
    basis: str = "sto-3g"
    unit: str = "angstrom"
    charge: int = 0
    shells: list = field(init=False)

    def __post_init__(self):
        scale = BOHR_PER_ANGSTROM if self.unit.lower().startswith("ang") else 1.0
        try:
            basis_set = BASIS_SETS[self.basis.lower()]
        except KeyError:
            raise ValueError(
                f"Unknown basis '{self.basis}'. Available: {sorted(BASIS_SETS)}"
            ) from None
        self.atoms = [
            (sym, np.asarray(xyz, dtype=np.float64) * scale) for sym, xyz in self.atoms
        ]
        self.shells = []
        for sym, center in self.atoms:
            if sym not in basis_set:
                raise ValueError(f"No '{self.basis}' data for element '{sym}'")
            for l, prims in basis_set[sym]:
                exps = np.array([a for a, _ in prims], dtype=np.float64)
                coefs = np.array([c for _, c in prims], dtype=np.float64)
                coefs = coefs * _prim_norm(exps, l)
                # renormalize the contracted (l,0,0) function
                ia = exps[:, None] + exps[None, :]
                ee = (np.pi / ia) ** 1.5 * _DFACT[2 * l - 1] / (2.0 * ia) ** l
                s_self = float(coefs @ ee @ coefs)
                coefs = coefs / np.sqrt(s_self)
                self.shells.append(Shell(l, center, exps, coefs))

    @property
    def nao(self) -> int:
        """Emitted AO count: real solid harmonics (5 per d shell, not 6)."""
        return sum(sh.nsph for sh in self.shells)

    @property
    def nao_cart(self) -> int:
        return sum(sh.ncomp for sh in self.shells)

    @property
    def nelectron(self) -> int:
        return sum(ELEMENT_Z[sym] for sym, _ in self.atoms) - self.charge

    @property
    def charges(self) -> np.ndarray:
        return np.array([ELEMENT_Z[sym] for sym, _ in self.atoms], dtype=np.float64)

    @property
    def coords(self) -> np.ndarray:
        return np.array([xyz for _, xyz in self.atoms])


def nuclear_repulsion(mol: Molecule) -> float:
    z = mol.charges
    r = mol.coords
    e = 0.0
    for i in range(len(z)):
        for j in range(i + 1, len(z)):
            e += z[i] * z[j] / np.linalg.norm(r[i] - r[j])
    return e


# --- Boys function -----------------------------------------------------------


def _boys_all(nmax: int, x: np.ndarray) -> np.ndarray:
    """``F_n(x)`` for n = 0..nmax, shape (nmax+1, len(x)).

    Top order from Kummer's function (exact), lower orders by the stable
    downward recursion ``F_n = (2x F_{n+1} + e^{-x}) / (2n + 1)``.
    """
    x = np.asarray(x, dtype=np.float64)
    out = np.empty((nmax + 1, x.size), dtype=np.float64)
    out[nmax] = hyp1f1(nmax + 0.5, nmax + 1.5, -x.ravel()) / (2 * nmax + 1)
    ex = np.exp(-x.ravel())
    for n in range(nmax - 1, -1, -1):
        out[n] = (2.0 * x.ravel() * out[n + 1] + ex) / (2 * n + 1)
    return out


# --- Hermite expansion coefficients -----------------------------------------


def _hermite_E(la: int, lb: int, pa, pb, inv2p, kab):
    """E^{ij}_t over a vector of primitive pairs, as dict ``(i, j, t) -> array``.

    ``pa``/``pb`` are the (P-A)/(P-B) components, ``inv2p = 1/(2p)``,
    ``kab = exp(-mu * Q^2)`` — all arrays over the flattened pair axis.
    """
    E = {(0, 0, 0): kab}
    zero = np.zeros_like(kab)

    def get(i, j, t):
        if t < 0 or t > i + j:
            return zero
        return E[(i, j, t)]

    for i in range(1, la + 1):
        for t in range(i + 1):
            E[(i, 0, t)] = (
                inv2p * get(i - 1, 0, t - 1)
                + pa * get(i - 1, 0, t)
                + (t + 1) * get(i - 1, 0, t + 1)
            )
    for j in range(1, lb + 1):
        for i in range(la + 1):
            for t in range(i + j + 1):
                E[(i, j, t)] = (
                    inv2p * get(i, j - 1, t - 1)
                    + pb * get(i, j - 1, t)
                    + (t + 1) * get(i, j - 1, t + 1)
                )
    return E


# --- Hermite Coulomb integrals ----------------------------------------------


def _hermite_R(tmax: int, umax: int, vmax: int, p, pc):
    """``R^0_{tuv}`` over a vector of charge-distribution pairs.

    ``p`` (pair exponent) and ``pc`` (3, n) displacement arrays; returns a
    dict ``(t, u, v) -> array``.
    """
    n_tot = tmax + umax + vmax
    x = p * (pc[0] ** 2 + pc[1] ** 2 + pc[2] ** 2)
    F = _boys_all(n_tot, x)
    memo = {}

    def R(n, t, u, v):
        key = (n, t, u, v)
        if key in memo:
            return memo[key]
        if t < 0 or u < 0 or v < 0:
            return 0.0
        if t == u == v == 0:
            val = (-2.0 * p) ** n * F[n]
        elif t > 0:
            val = (t - 1) * R(n + 1, t - 2, u, v) + pc[0] * R(n + 1, t - 1, u, v)
        elif u > 0:
            val = (u - 1) * R(n + 1, t, u - 2, v) + pc[1] * R(n + 1, t, u - 1, v)
        else:
            val = (v - 1) * R(n + 1, t, u, v - 2) + pc[2] * R(n + 1, t, u, v - 1)
        memo[key] = val
        return val

    return {
        (t, u, v): R(0, t, u, v)
        for t in range(tmax + 1)
        for u in range(umax + 1)
        for v in range(vmax + 1)
    }


# --- shell-pair data ---------------------------------------------------------


class _ShellPair:
    """Precomputed primitive-pair quantities for one (shell_a, shell_b)."""

    def __init__(self, sa: Shell, sb: Shell, extra_j: int = 0):
        a = sa.exps[:, None]
        b = sb.exps[None, :]
        self.p = (a + b).ravel()
        mu = (a * b / (a + b)).ravel()
        ab = sa.center - sb.center
        self.cc = (sa.coefs[:, None] * sb.coefs[None, :]).ravel()
        P = (a[..., None] * sa.center + b[..., None] * sb.center) / (a + b)[..., None]
        self.P = P.reshape(-1, 3)
        pa = self.P - sa.center
        pb = self.P - sb.center
        inv2p = 1.0 / (2.0 * self.p)
        self.E = []
        for d in range(3):
            kab = np.exp(-mu * ab[d] ** 2)
            self.E.append(
                _hermite_E(sa.l, sb.l + extra_j, pa[:, d], pb[:, d], inv2p, kab)
            )
        self.la, self.lb = sa.l, sb.l
        self.comps_a = _CART[sa.l]
        self.comps_b = _CART[sb.l]


# --- one-electron integrals --------------------------------------------------


def _overlap_kinetic_block(sp: _ShellPair, b_exps_flat):
    """(S_block, T_block) for one shell pair, shapes (ncomp_a, ncomp_b)."""
    pref = (np.pi / sp.p) ** 1.5
    na, nb = len(sp.comps_a), len(sp.comps_b)
    S = np.zeros((na, nb))
    T = np.zeros((na, nb))
    b = b_exps_flat

    def s1d(d, i, j):
        return sp.E[d].get((i, j, 0), 0.0)

    def k1d(d, i, j):
        val = b * (2 * j + 1) * s1d(d, i, j) - 2.0 * b**2 * s1d(d, i, j + 2)
        if j >= 2:
            val = val - 0.5 * j * (j - 1) * s1d(d, i, j - 2)
        return val

    for ia, (ax, ay, az) in enumerate(sp.comps_a):
        for ib, (bx, by, bz) in enumerate(sp.comps_b):
            sx, sy, sz = s1d(0, ax, bx), s1d(1, ay, by), s1d(2, az, bz)
            S[ia, ib] = np.sum(sp.cc * pref * sx * sy * sz)
            t = (
                k1d(0, ax, bx) * sy * sz
                + sx * k1d(1, ay, by) * sz
                + sx * sy * k1d(2, az, bz)
            )
            T[ia, ib] = np.sum(sp.cc * pref * t)
    return S, T


def _nuclear_block(sp: _ShellPair, charges: np.ndarray, coords: np.ndarray):
    """Nuclear-attraction block for one shell pair, shape (ncomp_a, ncomp_b)."""
    na, nb = len(sp.comps_a), len(sp.comps_b)
    V = np.zeros((na, nb))
    lmax = sp.la + sp.lb
    pref = 2.0 * np.pi / sp.p
    for z, c in zip(charges, coords):
        pc = (sp.P - c).T  # (3, npair)
        R = _hermite_R(lmax, lmax, lmax, sp.p, pc)
        for ia, (ax, ay, az) in enumerate(sp.comps_a):
            for ib, (bx, by, bz) in enumerate(sp.comps_b):
                acc = 0.0
                for t in range(ax + bx + 1):
                    ex = sp.E[0].get((ax, bx, t))
                    for u in range(ay + by + 1):
                        ey = sp.E[1].get((ay, by, u))
                        for v in range(az + bz + 1):
                            ez = sp.E[2].get((az, bz, v))
                            acc = acc + ex * ey * ez * R[(t, u, v)]
                V[ia, ib] -= z * np.sum(sp.cc * pref * acc)
    return V


# --- two-electron integrals --------------------------------------------------


def _eri_quartet(spab: _ShellPair, spcd: _ShellPair):
    """(ab|cd) block, shape (ncomp_a, ncomp_b, ncomp_c, ncomp_d)."""
    p = spab.p[:, None]
    q = spcd.p[None, :]
    alpha = (p * q / (p + q)).ravel()
    pq = (spab.P[:, None, :] - spcd.P[None, :, :]).reshape(-1, 3).T  # (3, nab*ncd)
    lab = spab.la + spab.lb
    lcd = spcd.la + spcd.lb
    R = _hermite_R(lab + lcd, lab + lcd, lab + lcd, alpha, pq)
    nab, ncd = len(spab.p), len(spcd.p)
    pref = (
        2.0 * np.pi**2.5 / (p * q * np.sqrt(p + q))
        * spab.cc[:, None] * spcd.cc[None, :]
    ).ravel()

    out = np.empty(
        (len(spab.comps_a), len(spab.comps_b), len(spcd.comps_a), len(spcd.comps_b))
    )
    for ia, (ax, ay, az) in enumerate(spab.comps_a):
        for ib, (bx, by, bz) in enumerate(spab.comps_b):
            # bra Hermite coefficients (over nab)
            bra = {}
            for t in range(ax + bx + 1):
                ex = spab.E[0].get((ax, bx, t))
                for u in range(ay + by + 1):
                    exy = ex * spab.E[1].get((ay, by, u))
                    for v in range(az + bz + 1):
                        bra[(t, u, v)] = exy * spab.E[2].get((az, bz, v))
            for ic, (cx, cy, cz) in enumerate(spcd.comps_a):
                for id_, (dx, dy, dz) in enumerate(spcd.comps_b):
                    acc = 0.0
                    for tau in range(cx + dx + 1):
                        kx = spcd.E[0].get((cx, dx, tau))
                        for nu in range(cy + dy + 1):
                            kxy = kx * spcd.E[1].get((cy, dy, nu))
                            for phi in range(cz + dz + 1):
                                ket = kxy * spcd.E[2].get((cz, dz, phi))
                                sgn = -1.0 if (tau + nu + phi) % 2 else 1.0
                                for (t, u, v), bval in bra.items():
                                    acc = acc + sgn * (
                                        bval[:, None] * ket[None, :]
                                    ).ravel() * R[(t + tau, u + nu, v + phi)]
                    out[ia, ib, ic, id_] = np.sum(pref * acc)
    return out


def _sph_transform_matrix(shells) -> np.ndarray:
    """Block-diagonal Cartesian->spherical map, shape (nao_cart, nao_sph)."""
    ncart = sum(sh.ncomp for sh in shells)
    nsph = sum(sh.nsph for sh in shells)
    c = np.zeros((ncart, nsph))
    ic = isph = 0
    for sh in shells:
        c[ic : ic + sh.ncomp, isph : isph + sh.nsph] = _C2S[sh.l].T
        ic += sh.ncomp
        isph += sh.nsph
    return c


def ao_integrals(mol: Molecule, backend: str = "auto"):
    """All AO integrals: ``(S, T, V, eri)`` with eri in chemist ``(pq|rs)``.

    Integrals are evaluated over Cartesian Gaussians and, for any shell with
    ``l >= 2``, transformed to real solid harmonics (so a d shell emits 5
    AOs, matching the spherical-harmonic convention of correlation-consistent
    basis sets — the reference's guides get this from PySCF's default
    ``cart=False``).

    ``backend="auto"`` uses the native C++ McMurchie-Davidson kernel when
    available (the Python quartet loops cost ~40 s for N2/cc-pVDZ; the native
    path is ~2 orders faster and pinned to 1e-12 against this module in
    ``tests/test_chem_native.py``); ``"numpy"`` forces the in-module path.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend != "numpy":
        from .. import native

        out = native.ao_integrals_cart(mol.shells, mol.charges, mol.coords)
        if out is not None:
            S, T, V, eri = out
            return _to_spherical(mol.shells, S, T, V, eri)
        if backend == "native":
            raise RuntimeError(
                "native integrals requested but libsqdcore is unavailable "
                "or a shell has l > 2"
            )
    shells = mol.shells
    nao = mol.nao_cart
    offs = np.cumsum([0] + [sh.ncomp for sh in shells])
    S = np.zeros((nao, nao))
    T = np.zeros((nao, nao))
    V = np.zeros((nao, nao))
    charges, coords = mol.charges, mol.coords

    pairs = {}
    for i, si in enumerate(shells):
        for j, sj in enumerate(shells[: i + 1]):
            sp = _ShellPair(si, sj, extra_j=2)  # extra_j covers the kinetic shift
            pairs[(i, j)] = sp
            b_flat = np.broadcast_to(sj.exps[None, :], (len(si.exps), len(sj.exps))).ravel()
            sb, tb = _overlap_kinetic_block(sp, b_flat)
            vb = _nuclear_block(sp, charges, coords)
            sl_i = slice(offs[i], offs[i + 1])
            sl_j = slice(offs[j], offs[j + 1])
            S[sl_i, sl_j] = sb
            T[sl_i, sl_j] = tb
            V[sl_i, sl_j] = vb
            if i != j:
                S[sl_j, sl_i] = sb.T
                T[sl_j, sl_i] = tb.T
                V[sl_j, sl_i] = vb.T

    eri = np.zeros((nao, nao, nao, nao))
    pair_list = sorted(pairs)
    for a_idx, (i, j) in enumerate(pair_list):
        for (k, l) in pair_list[: a_idx + 1]:
            block = _eri_quartet(pairs[(i, j)], pairs[(k, l)])
            _fill_eri(eri, block, offs, i, j, k, l)

    return _to_spherical(shells, S, T, V, eri)


def _to_spherical(shells, S, T, V, eri):
    """Apply the Cartesian -> real-solid-harmonic transform (identity for s/p)."""
    if any(sh.l >= 2 for sh in shells):
        c = _sph_transform_matrix(shells)
        S = c.T @ S @ c
        T = c.T @ T @ c
        V = c.T @ V @ c
        eri = np.einsum("pqrs,pi->iqrs", eri, c, optimize=True)
        eri = np.einsum("iqrs,qj->ijrs", eri, c, optimize=True)
        eri = np.einsum("ijrs,rk->ijks", eri, c, optimize=True)
        eri = np.einsum("ijks,sl->ijkl", eri, c, optimize=True)
    return S, T, V, eri


def _fill_eri(eri, block, offs, i, j, k, l):
    """Scatter one shell-quartet block into all 8 symmetric positions."""
    si = slice(offs[i], offs[i + 1])
    sj = slice(offs[j], offs[j + 1])
    sk = slice(offs[k], offs[k + 1])
    sl = slice(offs[l], offs[l + 1])
    eri[si, sj, sk, sl] = block
    eri[sj, si, sk, sl] = block.transpose(1, 0, 2, 3)
    eri[si, sj, sl, sk] = block.transpose(0, 1, 3, 2)
    eri[sj, si, sl, sk] = block.transpose(1, 0, 3, 2)
    eri[sk, sl, si, sj] = block.transpose(2, 3, 0, 1)
    eri[sl, sk, si, sj] = block.transpose(3, 2, 0, 1)
    eri[sk, sl, sj, si] = block.transpose(2, 3, 1, 0)
    eri[sl, sk, sj, si] = block.transpose(3, 2, 1, 0)
