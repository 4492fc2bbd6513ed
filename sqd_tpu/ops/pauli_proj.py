# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Pauli-operator projection onto a computational-basis subspace (device kernels).

Device replacement for the reference's per-term JAX kernels + explicit
``scipy.sparse.coo_matrix`` accumulation (``qubit.py:78-144, 167-300``;
SURVEY.md C14/C15/N5).  Differences by design:

* Bitstrings are packed uint32 words — the reference's 63-qubit ceiling
  (``qubit.py:62``) does not exist here.
* For each Pauli term ``P = (z, x)`` the connected configuration of a basis
  state is ``conn = bits XOR x`` and the amplitude is
  ``i^{#Y} * (-1)^{popcount(bits AND z)}`` (the same qubit-wise algebra as
  reference ``qubit.py:213-268``, vectorized over packed words).
* Membership of connected strings resolves by branchless binary search over
  the sorted packed set, producing a **permutation table** per term.  The
  projected operator is then *matrix-free*: ``(H v)[i] = sum_t c_t a_t[i] *
  v[perm_t[i]]`` — pure gathers, no sparse matrix is ever materialized
  (BASELINE.json north star).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from . import bitpack

__all__ = [
    "pauli_masks_to_packed",
    "connected_table",
    "connected_table_pair",
    "diagonal_sign_table",
    "pauli_term_table",
    "ProjectedPauliOperator",
    "build_projected_operator",
    "estimate_operator_bytes",
]


def pauli_masks_to_packed(z: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(z, x) boolean qubit masks -> packed uint32 words (bit q = qubit q)."""
    # qubit q == bit q: reverse into the bool-matrix column convention
    zrow = np.asarray(z, dtype=bool)[::-1][None, :]
    xrow = np.asarray(x, dtype=bool)[::-1][None, :]
    return bitpack.pack_bool_matrix(zrow)[0], bitpack.pack_bool_matrix(xrow)[0]


@jax.jit
def connected_table(sorted_packed, z_words, x_words):
    """Per-row (column index, sign) of one Pauli term over the sorted subspace.

    Returns ``(col, sign)``: ``col[i]`` is the subspace index of
    ``bits_i XOR x`` (or ``d`` if absent), ``sign[i] = (-1)^{popcount(b & z)}``.
    The constant ``i^{#Y}`` phase is NOT included (multiply per term).
    """
    d = sorted_packed.shape[0]
    conn = sorted_packed ^ x_words[None, :]
    col = bitpack.jnp_find_packed(sorted_packed, conn)
    sign = 1 - 2 * (bitpack.jnp_popcount_rows(sorted_packed & z_words[None, :]) % 2)
    ok = col >= 0
    return jnp.where(ok, col, d).astype(jnp.int32), jnp.where(ok, sign, 0).astype(jnp.int8)


@jax.jit
def diagonal_sign_table(sorted_packed, z_words):
    """Per-row sign of a DIAGONAL (X-free) Pauli term, fully on device.

    For a term with no X/Y component every basis state connects to itself,
    so the whole projection is the sign vector
    ``(-1)^{popcount(bits AND z)}`` — one streaming popcount over the packed
    words, no membership search (the reference runs its full sorted ``isin``
    even here; this is its benchmark's Z^40 case,
    ``docs/guides/benchmark_pauli_projection.ipynb`` cell 7).
    """
    return (
        1 - 2 * (bitpack.jnp_popcount_rows(sorted_packed & z_words[None, :]) % 2)
    ).astype(jnp.int8)


def pauli_term_table(sorted_packed, pauli):
    """Matrix-free (col, sign, phase) table of ONE Pauli term, on device.

    The device-resident production form of reference
    ``matrix_elements_from_pauli`` (``qubit.py:167-240``): ``col[i]`` is the
    subspace index of the state connected to row ``i`` (sentinel ``d`` when
    the connected string is outside the subspace), ``sign[i]`` the real sign,
    and ``phase = i^{#Y}`` the constant per-term factor.  Input and outputs
    live on device; nothing is transferred to the host.

    Args:
        sorted_packed: (d, W) uint32 device array, rows sorted ascending.
        pauli: object with boolean ``z``/``x`` arrays in qubit order.
    """
    z = np.asarray(pauli.z)
    x = np.asarray(pauli.x)
    zw, xw = pauli_masks_to_packed(z, x)
    w = sorted_packed.shape[1]
    phase = 1j ** int(np.sum(z & x))
    d = sorted_packed.shape[0]
    if not np.asarray(xw[:w]).any():
        sign = diagonal_sign_table(sorted_packed, jnp.asarray(zw[:w]))
        col = jnp.arange(d, dtype=jnp.int32)
        return col, sign, phase
    table_fn = connected_table_pair if d >= 1_000_000 else connected_table
    col, sign = table_fn(sorted_packed, jnp.asarray(zw[:w]), jnp.asarray(xw[:w]))
    return col, sign, phase


@jax.jit
def connected_table_rank(sorted_packed, z_words, x_words):
    """Sort-rank variant of :func:`connected_table` for very large subspaces.

    Binary search costs ~log2(d) rounds of random 8-byte device-memory
    gathers at d ~ 5e7.  Instead: sort the concatenation of
    (table, queries) with a tie-break flag placing table entries first, take a
    cumulative count of table entries, and verify each query against its
    immediate table predecessor — one device sort + one gather total.
    """
    n, w = sorted_packed.shape
    conn = sorted_packed ^ x_words[None, :]
    combined = jnp.concatenate([sorted_packed, conn], axis=0)
    flags = jnp.concatenate(
        [jnp.zeros(n, jnp.uint32), jnp.ones(n, jnp.uint32)]
    )
    payload = jnp.tile(jnp.arange(n, dtype=jnp.int32), 2)
    keys = [combined[:, j] for j in range(w - 1, -1, -1)] + [flags]
    out = jax.lax.sort(keys + [payload], num_keys=w + 1)
    flags_s = out[w]
    payload_s = out[w + 1]
    cum_table = jnp.cumsum(1 - flags_s) - 1  # index of last table entry <= here
    cum_table = jnp.maximum(cum_table, 0).astype(jnp.int32)
    sorted_words = jnp.stack([out[w - 1 - j] for j in range(w)], axis=1)
    pred = sorted_packed[cum_table]  # (2n, W) gather of the candidate match
    match = jnp.all(pred == sorted_words, axis=1) & (flags_s == 1)
    col_sorted = jnp.where(match, cum_table, n).astype(jnp.int32)
    # scatter back to query order; table rows aim out-of-bounds and drop
    col = jnp.full(n, n, jnp.int32).at[
        jnp.where(flags_s == 1, payload_s, n)
    ].set(col_sorted, mode="drop")
    sign = 1 - 2 * (bitpack.jnp_popcount_rows(sorted_packed & z_words[None, :]) % 2)
    sign = jnp.where(col < n, sign, 0).astype(jnp.int8)
    return col, sign


def _pair_col(sorted_packed, x_words):
    """Connected-index column of ONE non-diagonal x-mask, involution pairing.

    Requires ``x != 0`` (diagonal terms connect every row to itself — with
    ``x == 0`` the pairing below would report every row absent).

    For a non-diagonal term the connected map ``a -> a ^ x`` is an
    INVOLUTION: ``a`` and ``b`` are partners iff ``b = a ^ x``, i.e. iff they
    share the key ``k = min(a, a ^ x)`` (and each key is shared by at most 2
    distinct rows, since rows are unique).  Sorting the n rows by
    ``(k, a > a^x)`` therefore lands every partner pair ADJACENT, with the
    smaller element first — membership resolves by comparing neighbours.

    vs :func:`connected_table_rank` this sorts n elements instead of 2n and
    replaces its (2n,)-row random predecessor gather (slice-count-bound,
    ~0.85 s per 5e7 slices on this chip) with shifted-by-one comparisons,
    which XLA lowers to contiguous streams.

    Depends on ``x`` ONLY (not ``z``): terms sharing an x-mask share this
    table, which is what :func:`build_projected_operator` exploits.
    """
    n, w = sorted_packed.shape
    conn = sorted_packed ^ x_words[None, :]
    # lexicographic a > a^x, most-significant word last (bitpack convention)
    gt = jnp.zeros(n, bool)
    eq = jnp.ones(n, bool)
    for j in range(w - 1, -1, -1):
        aj, cj = sorted_packed[:, j], conn[:, j]
        gt = gt | (eq & (aj > cj))
        eq = eq & (aj == cj)
    k = jnp.where(gt[:, None], conn, sorted_packed)  # min(a, a^x) per row
    flag = gt.astype(jnp.uint32)
    payload = jnp.arange(n, dtype=jnp.int32)
    keys = [k[:, j] for j in range(w - 1, -1, -1)] + [flag]
    out = jax.lax.sort(keys + [payload], num_keys=w + 1)
    flag_s = out[w]
    payload_s = out[w + 1]
    kw = out[:w]  # sorted key words, msb-first
    same_prev = jnp.ones(n, bool).at[0].set(False)
    for col_w in kw:
        same_prev = same_prev & (col_w == jnp.roll(col_w, 1))
    # pair = (flag 0 at i, flag 1 at i+1) with equal k: each side reads its
    # immediate neighbour — shifted loads, no random gather
    prev_is_partner = same_prev & (flag_s == 1) & (jnp.roll(flag_s, 1) == 0)
    next_is_partner = jnp.roll(prev_is_partner, -1) & (flag_s == 0)
    partner = jnp.where(
        prev_is_partner,
        jnp.roll(payload_s, 1),
        jnp.where(next_is_partner, jnp.roll(payload_s, -1), n),
    ).astype(jnp.int32)
    return jnp.zeros(n, jnp.int32).at[payload_s].set(partner)


@jax.jit
def connected_table_pair(sorted_packed, z_words, x_words):
    """Involution-pairing variant of :func:`connected_table` for huge subspaces.

    ``(col, sign)`` of one term; see :func:`_pair_col` for the pairing design
    (and its ``x != 0`` requirement).
    """
    n = sorted_packed.shape[0]
    col = _pair_col(sorted_packed, x_words)
    sign = 1 - 2 * (bitpack.jnp_popcount_rows(sorted_packed & z_words[None, :]) % 2)
    sign = jnp.where(col < n, sign, 0).astype(jnp.int8)
    return col, sign


_pair_col_batched = jax.jit(jax.vmap(_pair_col, in_axes=(None, 0)))


def _search_col(sorted_packed, x_words):
    """Connected-index column of one x-mask via branchless binary search."""
    d = sorted_packed.shape[0]
    col = bitpack.jnp_find_packed(sorted_packed, sorted_packed ^ x_words[None, :])
    return jnp.where(col >= 0, col, d).astype(jnp.int32)


_search_col_batched = jax.jit(jax.vmap(_search_col, in_axes=(None, 0)))


def _unpacked_signs(sign_words, d, dt):
    """(k, ceil(d/32)) packed parity words -> (k, d) ±1 values in dtype ``dt``.

    Bit ``i & 31`` of word ``i >> 5`` holds term parity at row ``i`` — pure
    elementwise shifts, cheaper to stream from device memory than any float weight row
    (d/8 bytes vs 4d/8d).
    """
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (sign_words[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    s = 1.0 - 2.0 * bits.astype(dt)
    return s.reshape(sign_words.shape[0], -1)[:, :d]


@jax.tree_util.register_pytree_node_class
@dataclass(frozen=True)
class ProjectedPauliOperator:
    """Matrix-free projected Pauli-sum over a sorted bitstring subspace.

    Terms are stored GROUPED BY X-MASK: the connected map ``a -> a ^ x``
    depends only on a term's x component, so all terms sharing an x-mask
    share one permutation table, and their ``coeff * i^{#Y} * (-1)^{b & z}``
    amplitudes fold into a single per-group weight vector.  The matvec is
    then ``(H v)[i] = hdiag[i] v[i] + sum_u W_u[i] * v[perm_u[i]]`` over the
    non-diagonal unique x-masks — for a Heisenberg ring (XXⱼ/YYⱼ share
    x-masks; ZZⱼ and the field are all diagonal) this is ~4x fewer gather
    rounds than per-term tables, and the build does ~4x less membership work.

    Memory model (the reference benchmark's headline scale is d = 5e7 rows,
    ``docs/guides/benchmark_pauli_projection.ipynb``):

    * The DIAGONAL x-group (``x == 0``) is implicit — its permutation is the
      identity and its weight IS ``hdiag``, so it costs one (d,) vector, not
      an (d,)-perm + (d,)-weight pair.
    * Weights are stored either DENSE (``weight_re``/``weight_im``,
      ``(U, d)`` float) or BIT-PACKED (``sign_words`` + per-term scalar
      coefficients).  A term's weight contribution is ``c_t · (±1)``, so one
      parity BIT per row reconstructs the exact f64 weight on the fly:
      ``W_u[i] = sum_{t in u} c_t (1 - 2 bit_t[i])``.  Packed storage costs
      ``d/8`` bytes per term vs ``8d`` per dense-f64 group — 16x less at two
      terms per group — with NO precision loss (signs are exact; the fold
      happens in the matvec dtype).  ``build_projected_operator`` picks the
      packed form automatically at large d.
    * Large-d matvecs run as a ``lax.scan`` over x-groups so the transient
      footprint is O(d), not O(U·d).

    At d = 5e7 / 40 qubits the 88-term Heisenberg operator is then
    ~4.4 GB perm + ~0.26 GB sign words + 0.4 GB hdiag, where a dense-f64
    layout would take 9.2 GB weights + 4.8 GB perm.  Use :func:`estimate_operator_bytes` to plan before building.

    Complex weights are stored SPLIT (re/im), so the operator and the
    Davidson stay in real arithmetic.  When any term has an
    imaginary effective coefficient, the operator acts on the REAL EMBEDDING
    of the complex Hermitian matrix ``H = A + iB``: vectors are
    ``[v_re; v_im]`` of length ``2d`` and ``H_embed = [[A, -B], [B, A]]``
    (symmetric; every eigenvalue of H doubled), so the whole eigensolve runs
    in f64 real arithmetic.
    """

    perm: jax.Array  # (U_nd, d) int32 — NON-diagonal x-groups, sentinel d
    weight_re: jax.Array  # dense modes: (U_nd, d) float; packed mode: (0, 0)
    weight_im: jax.Array  # dense complex: (U_nd, d); otherwise (0, 0)
    hdiag: jax.Array  # (d,) f64 — the implicit diagonal group's real weight
    hdiag_im: jax.Array  # (d,) f64 when the diagonal weight has an imag part, else (0,)
    sign_words: jax.Array  # packed mode: (U_nd, kmax, ceil(d/32)) uint32; else (0, 0, 0)
    coeff_re: jax.Array  # packed mode: (U_nd, kmax) f64; else (0, 0)
    coeff_im: jax.Array  # packed complex: (U_nd, kmax) f64; else (0, 0)
    is_complex: bool = False  # static: any term coeff with nonzero imag part
    has_diag: bool = False  # static: a diagonal (x == 0) group exists
    packed_weights: bool = False  # static: weights stored as sign bits + coeffs
    scan_matvec: bool = False  # static: matvec scans over groups (O(d) transients)

    def tree_flatten(self):
        children = (
            self.perm, self.weight_re, self.weight_im, self.hdiag,
            self.hdiag_im, self.sign_words, self.coeff_re, self.coeff_im,
        )
        aux = (self.is_complex, self.has_diag, self.packed_weights, self.scan_matvec)
        return children, aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, is_complex=aux[0], has_diag=aux[1],
                   packed_weights=aux[2], scan_matvec=aux[3])

    @property
    def dim(self) -> int:
        return self.hdiag.shape[0]

    @property
    def num_groups(self) -> int:
        """Number of unique x-masks (incl. the implicit diagonal group)."""
        return self.perm.shape[0] + (1 if self.has_diag else 0)

    @property
    def embedded_dim(self) -> int:
        """Length of the vectors :meth:`matvec` acts on."""
        return 2 * self.dim if self.is_complex else self.dim

    @property
    def shape(self) -> tuple[int, int]:
        return (self.dim, self.dim)

    @property
    def memory_bytes(self) -> int:
        """Total bytes of the stored arrays (perm + weights/signs + diagonal)."""
        children, _ = self.tree_flatten()
        return sum(int(np.prod(c.shape)) * c.dtype.itemsize for c in children)

    # ---- matvec ------------------------------------------------------------

    def _diag_terms(self, vr, vi, dt):
        hd = self.hdiag.astype(dt)
        if vi is None:
            return hd * vr, None
        out_r, out_i = hd * vr, hd * vi
        if self.hdiag_im.shape[0]:
            hdi = self.hdiag_im.astype(dt)
            out_r = out_r - hdi * vi
            out_i = out_i + hdi * vr
        return out_r, out_i

    def _group_xs(self):
        """Per-group scan operands: (perm_u, weight source...)."""
        if self.packed_weights:
            if self.is_complex:
                return (self.perm, self.sign_words, self.coeff_re, self.coeff_im)
            return (self.perm, self.sign_words, self.coeff_re)
        if self.is_complex:
            return (self.perm, self.weight_re, self.weight_im)
        return (self.perm, self.weight_re)

    def _group_weights_of(self, x, dt):
        """One scan step's (w_re, w_im) from its operands (w_im may be None)."""
        d = self.dim
        if self.packed_weights:
            if self.is_complex:
                _, sw, cre, cim = x
            else:
                (_, sw, cre), cim = x, None
            # fold the per-term coefficients into this group's weight row
            s = _unpacked_signs(sw, d, dt)
            w_re = jnp.sum(cre.astype(dt)[:, None] * s, axis=0)
            w_im = jnp.sum(cim.astype(dt)[:, None] * s, axis=0) if cim is not None else None
            return w_re, w_im
        if self.is_complex:
            _, wre, wim = x
            return wre.astype(dt), wim.astype(dt)
        return x[1].astype(dt), None

    def _matvec_real(self, v, dt):
        out, _ = self._diag_terms(v, None, dt)
        if self.perm.shape[0] == 0:
            return out
        v_pad = jnp.concatenate([v, jnp.zeros((1,), dt)])
        if not self.scan_matvec:
            return out + jnp.sum(self.weight_re.astype(dt) * v_pad[self.perm], axis=0)

        def body(acc, x):
            w_re, _ = self._group_weights_of(x, dt)
            return acc + w_re * v_pad[x[0]], None

        out, _ = jax.lax.scan(body, out, self._group_xs())
        return out

    def _matvec_complex(self, vr, vi, dt):
        out_r, out_i = self._diag_terms(vr, vi, dt)
        if self.perm.shape[0] == 0:
            return out_r, out_i
        zero = jnp.zeros((1,), dt)
        vr_pad = jnp.concatenate([vr, zero])
        vi_pad = jnp.concatenate([vi, zero])
        if not self.scan_matvec:
            pr = vr_pad[self.perm]  # (U, d)
            pi = vi_pad[self.perm]
            w_re = self.weight_re.astype(dt)
            w_im = self.weight_im.astype(dt)
            out_r = out_r + jnp.sum(w_re * pr - w_im * pi, axis=0)
            out_i = out_i + jnp.sum(w_im * pr + w_re * pi, axis=0)
            return out_r, out_i

        def body(acc, x):
            ar, ai = acc
            w_re, w_im = self._group_weights_of(x, dt)
            pr = vr_pad[x[0]]
            pi = vi_pad[x[0]]
            ar = ar + w_re * pr - w_im * pi
            ai = ai + w_im * pr + w_re * pi
            return (ar, ai), None

        (out_r, out_i), _ = jax.lax.scan(body, (out_r, out_i), self._group_xs())
        return out_r, out_i

    def matvec(self, v: jax.Array) -> jax.Array:
        """``H v`` via per-x-group gathers.

        Convention matches the reference projection (``qubit.py:167-240``):
        ``A[row, col] = amp(row)`` with ``col`` the connected index, i.e.
        ``(H v)[row] = sum_t c_t a_t(row) v[col_t(row)]`` — here with the
        ``t`` sum folded into per-group weights (stored dense or
        reconstructed from packed sign bits, see the class docstring).

        For a complex operator ``v`` is the stacked real embedding
        ``[v_re; v_im]`` (length ``2d``).
        """
        dt = v.dtype
        if not self.is_complex:
            return self._matvec_real(v, dt)
        d = self.dim
        out_r, out_i = self._matvec_complex(v[:d], v[d:], dt)
        return jnp.concatenate([out_r, out_i])


def pauli_apply_flat(op: ProjectedPauliOperator, v: jax.Array) -> jax.Array:
    """Module-level matvec adapter (stable identity for jit caching)."""
    return op.matvec(v)


def _weights_chunk(sorted_packed, z_chunk, cre, cim, gid, num_groups, with_imag):
    """One term-chunk's contribution to the per-group weight vectors."""
    par = jax.vmap(
        lambda zz: bitpack.jnp_popcount_rows(sorted_packed & zz[None, :]) % 2
    )(z_chunk)
    s = (1 - 2 * par).astype(jnp.float64)  # (Tc, d) sign of each term
    wre = jnp.zeros((num_groups, s.shape[1]), jnp.float64).at[gid].add(cre[:, None] * s)
    if with_imag:
        wim = jnp.zeros((num_groups, s.shape[1]), jnp.float64).at[gid].add(
            cim[:, None] * s
        )
    else:
        wim = jnp.zeros((0, 0), jnp.float64)
    return wre, wim


@partial(jax.jit, static_argnames=("num_groups", "chunk", "with_imag"))
def _group_weights(sorted_packed, z_stack, c_re, c_im, group_id, *, num_groups, chunk, with_imag):
    """Per-group weights ``W_u[i] = sum_{t in u} c_t (-1)^{b_i & z_t}``.

    One compiled program: a ``lax.scan`` over term-chunks bounds the live
    ``(chunk, d)`` sign intermediate (88 terms x 5e7 rows would otherwise
    hold a 35 GB i8 buffer).  Inputs are padded to a multiple of ``chunk``
    with zero coefficients (harmless scatter-adds into group 0).
    """
    tpad = z_stack.shape[0]
    n_chunks = tpad // chunk
    xs = (
        z_stack.reshape(n_chunks, chunk, -1),
        c_re.reshape(n_chunks, chunk),
        c_im.reshape(n_chunks, chunk),
        group_id.reshape(n_chunks, chunk),
    )

    def step(carry, x):
        wre, wim = carry
        z, cr, ci, g = x
        dre, dim_ = _weights_chunk(sorted_packed, z, cr, ci, g, num_groups, with_imag)
        return (wre + dre, wim + dim_), None

    d = sorted_packed.shape[0]
    init = (
        jnp.zeros((num_groups, d), jnp.float64),
        jnp.zeros((num_groups, d) if with_imag else (0, 0), jnp.float64),
    )
    (wre, wim), _ = jax.lax.scan(step, init, xs)
    return wre, wim


@partial(jax.jit, static_argnames=("chunk", "dpad"))
def _sign_words_stack(sorted_packed, z_stack, *, chunk, dpad):
    """Packed parity words of each term: bit i of word i>>5 = popcount(b_i & z_t) & 1.

    Scan-chunked like :func:`_group_weights` so the live (chunk, dpad) parity
    intermediate stays bounded at large d.
    """
    tpad = z_stack.shape[0]
    n_chunks = tpad // chunk
    zs = z_stack.reshape(n_chunks, chunk, -1)
    shifts = jnp.arange(32, dtype=jnp.uint32)

    def step(_, z):
        par = jax.vmap(
            lambda zz: bitpack.jnp_popcount_rows(sorted_packed & zz[None, :]) & 1
        )(z).astype(jnp.uint32)
        par = jnp.pad(par, ((0, 0), (0, dpad - par.shape[1])))
        lanes = par.reshape(par.shape[0], -1, 32)
        words = jnp.sum(lanes << shifts[None, None, :], axis=2, dtype=jnp.uint32)
        return None, words

    _, words = jax.lax.scan(step, None, zs)
    return words.reshape(tpad, dpad // 32)


# per-term chunk cap for the sign scan (elements of the (chunk, d) buffer)
_WEIGHT_CHUNK_ELEMS = 50_000_000
# byte budget for the batched pairing sort's live buffers at large d
_PAIR_BATCH_BYTES = 1_500_000_000
# d at/above which auto weights switch to the bit-packed representation
_PACKED_WEIGHTS_MIN_D = 2_000_000
# dense (U, d) f64 weight bytes above which the matvec scans over groups
_SCAN_MATVEC_BYTES = 1_500_000_000


def estimate_operator_bytes(
    d: int,
    *,
    num_nondiag_groups: int,
    max_terms_per_group: int = 1,
    weights: str = "packed",
    is_complex: bool = False,
    has_diag: bool = True,
) -> int:
    """Predicted resident bytes of a :class:`ProjectedPauliOperator`.

    Plan device memory before building (the Davidson additionally holds
    ~2 x max_subspace vectors of ``embedded_dim`` in its dtype).

    Args:
        d: subspace dimension (rows).
        num_nondiag_groups: unique non-diagonal x-masks ``U``.
        max_terms_per_group: packed mode's per-group term-slot count ``kmax``.
        weights: ``"packed"`` | ``"dense64"`` | ``"dense32"``.
        is_complex: whether any effective coefficient is complex.
        has_diag: whether a diagonal (x == 0) group exists.
    """
    u = num_nondiag_groups
    total = u * d * 4  # perm int32
    total += d * 8 * (1 if has_diag else 0) * (2 if is_complex else 1)  # hdiag(+im)
    if weights == "packed":
        dw = -(-d // 32)
        total += u * max_terms_per_group * (dw * 4 + 8 * (2 if is_complex else 1))
    else:
        per = 8 if weights == "dense64" else 4
        total += u * d * per * (2 if is_complex else 1)
    return total


def build_projected_operator(
    sorted_packed: np.ndarray, paulis, coeffs, *, weights: str = "auto"
) -> ProjectedPauliOperator:
    """Assemble the matrix-free projected operator for a Pauli sum.

    Replaces the reference's per-term Python loop over
    ``matrix_elements_from_pauli`` + COO accumulation
    (``qubit.py:78-144``).  Terms are grouped by x-mask: one membership
    resolution per UNIQUE non-diagonal x (binary search batched in one
    vmapped program below 1e6 rows; chunk-batched involution-pairing sorts
    above), the diagonal group folds straight into ``hdiag``, and weights
    are stored dense or bit-packed per the memory model in
    :class:`ProjectedPauliOperator`.

    Args:
        sorted_packed: (d, W) uint32 — sorted unique packed bitstrings.
        paulis: sequence of :class:`sqd_tpu.primitives.Pauli`.
        coeffs: complex coefficients.
        weights: ``"auto"`` (packed at d >= 2e6 when groups are small, dense
            f64 otherwise), ``"dense64"``, ``"dense32"``, or ``"packed"``.
    """
    if weights not in ("auto", "dense64", "dense32", "packed"):
        raise ValueError(f"unknown weights mode: {weights!r}")
    sp = jnp.asarray(sorted_packed)
    d, w = sp.shape
    zws, xws, cs = [], [], []
    for pauli, c in zip(paulis, np.asarray(coeffs)):
        zw, xw = pauli_masks_to_packed(pauli.z, pauli.x)
        if np.any(zw[w:]) or np.any(xw[w:]):
            raise ValueError(
                f"Pauli term acts on more qubits ({len(np.asarray(pauli.z))}) than the "
                f"packed subspace encodes ({w * 32}); truncating its mask would build a "
                "wrong operator."
            )
        n_y = int(np.sum(np.asarray(pauli.z) & np.asarray(pauli.x)))
        zws.append(zw[:w])
        xws.append(xw[:w])
        cs.append(complex(c) * (1j**n_y))
    n_terms = len(cs)
    cs_arr = np.array(cs, dtype=np.complex128)
    is_complex = bool(np.any(cs_arr.imag != 0.0))

    # ---- group terms by x-mask (insertion order; diagonal group = x == 0) --
    group_of: dict[bytes, int] = {}
    group_id = np.empty(n_terms, dtype=np.int32)
    unique_x: list[np.ndarray] = []
    for t, xw in enumerate(xws):
        key = xw.tobytes()
        if key not in group_of:
            group_of[key] = len(unique_x)
            unique_x.append(xw)
        group_id[t] = group_of[key]
    num_groups = len(unique_x)
    x_arr = np.stack(unique_x) if num_groups else np.zeros((0, w), np.uint32)
    is_diag = ~x_arr.any(axis=1)
    has_diag = bool(is_diag.any())

    # remap non-diagonal groups to 0..U-1 preserving insertion order
    nd_order = np.nonzero(~is_diag)[0]
    u_nd = len(nd_order)
    remap = np.full(num_groups, -1, np.int32)
    remap[nd_order] = np.arange(u_nd, dtype=np.int32)
    term_is_diag = is_diag[group_id] if n_terms else np.zeros(0, bool)
    nd_terms = np.nonzero(~term_is_diag)[0]
    dg_terms = np.nonzero(term_is_diag)[0]
    x_nd = x_arr[nd_order]
    gid_nd = remap[group_id[nd_terms]]

    # ---- one membership table per unique non-diagonal x ---------------------
    if u_nd == 0:
        perm = jnp.zeros((0, d), jnp.int32)
    elif d >= 1_000_000:
        # the pairing sort holds O(d) buffers per x-mask: batch in chunks
        # sized to _PAIR_BATCH_BYTES instead of all-at-once or one-by-one
        per_x = d * (w + 2) * 4 * 3
        uc = max(1, min(u_nd, _PAIR_BATCH_BYTES // per_x))
        cols = []
        for start in range(0, u_nd, uc):
            batch = x_nd[start : start + uc]
            if len(batch) < uc:  # pad to the jitted shape with a repeat
                batch = np.concatenate([batch, np.tile(batch[-1:], (uc - len(batch), 1))])
            got = _pair_col_batched(sp, jnp.asarray(batch))
            cols.extend(got[k] for k in range(min(uc, u_nd - start)))
        perm = jnp.stack(cols)
    else:
        # binary search (x != 0 here; the diagonal group never reaches this)
        perm = _search_col_batched(sp, jnp.asarray(x_nd))

    def _fold(term_idx, n_groups, gid, with_imag):
        """Scan-chunked weight fold over a subset of terms."""
        tcnt = len(term_idx)
        chunk = max(1, min(tcnt, _WEIGHT_CHUNK_ELEMS // max(d, 1)))
        tpad = -(-tcnt // chunk) * chunk
        z_stack = np.zeros((tpad, w), dtype=np.uint32)
        z_stack[:tcnt] = np.stack([zws[t] for t in term_idx])
        c_re = np.zeros(tpad)
        c_im = np.zeros(tpad)
        c_re[:tcnt] = cs_arr[term_idx].real
        c_im[:tcnt] = cs_arr[term_idx].imag
        g = np.zeros(tpad, dtype=np.int32)
        g[:tcnt] = gid
        return _group_weights(
            sp, jnp.asarray(z_stack), jnp.asarray(c_re), jnp.asarray(c_im),
            jnp.asarray(g), num_groups=n_groups, chunk=chunk, with_imag=with_imag,
        )

    # ---- diagonal group folds straight into hdiag ---------------------------
    if len(dg_terms):
        diag_has_imag = is_complex and bool(np.any(cs_arr[dg_terms].imag != 0.0))
        hre, him = _fold(dg_terms, 1, np.zeros(len(dg_terms), np.int32), diag_has_imag)
        hdiag = hre[0]
        hdiag_im = him[0] if diag_has_imag else jnp.zeros((0,), jnp.float64)
    else:
        hdiag = jnp.zeros((d,), jnp.float64)
        hdiag_im = jnp.zeros((0,), jnp.float64)

    # ---- weight representation for the non-diagonal groups ------------------
    counts = np.bincount(gid_nd, minlength=u_nd) if u_nd else np.zeros(0, int)
    kmax = int(counts.max()) if u_nd else 0
    mode = weights
    if mode == "auto":
        # packed beats dense32 on bytes whenever kmax < 32 (d/8 per term vs
        # 4d per group) and is exact; keep the historical dense-f64 layout at
        # small d where footprint is irrelevant.
        mode = "packed" if (d >= _PACKED_WEIGHTS_MIN_D and u_nd and kmax <= 32) else "dense64"

    empty2 = jnp.zeros((0, 0), jnp.float64)
    sign_words = jnp.zeros((0, 0, 0), jnp.uint32)
    coeff_re = coeff_im = empty2
    weight_re = weight_im = empty2
    if u_nd and mode == "packed":
        tcnt = len(nd_terms)
        chunk = max(1, min(tcnt, _WEIGHT_CHUNK_ELEMS // max(d, 1)))
        tpad = -(-tcnt // chunk) * chunk
        z_stack = np.zeros((tpad, w), dtype=np.uint32)
        z_stack[:tcnt] = np.stack([zws[t] for t in nd_terms])
        dpad = -(-d // 32) * 32
        words = _sign_words_stack(sp, jnp.asarray(z_stack), chunk=chunk, dpad=dpad)
        slot = np.zeros(tcnt, np.int32)
        running = np.zeros(u_nd, np.int32)
        for i, g in enumerate(gid_nd):
            slot[i] = running[g]
            running[g] += 1
        sign_words = (
            jnp.zeros((u_nd, kmax, dpad // 32), jnp.uint32)
            .at[jnp.asarray(gid_nd), jnp.asarray(slot)]
            .set(words[:tcnt])
        )
        cre = np.zeros((u_nd, kmax))
        cim = np.zeros((u_nd, kmax))
        cre[gid_nd, slot] = cs_arr[nd_terms].real
        cim[gid_nd, slot] = cs_arr[nd_terms].imag
        coeff_re = jnp.asarray(cre)
        coeff_im = jnp.asarray(cim) if is_complex else empty2
    elif u_nd:
        wre, wim = _fold(nd_terms, u_nd, gid_nd, is_complex)
        wdt = jnp.float32 if mode == "dense32" else jnp.float64
        weight_re = wre.astype(wdt)
        weight_im = wim.astype(wdt) if is_complex else empty2

    per_w = 8 if mode == "dense64" else 4
    scan = mode == "packed" or (u_nd * d * per_w > _SCAN_MATVEC_BYTES)
    return ProjectedPauliOperator(
        perm=perm, weight_re=weight_re, weight_im=weight_im,
        hdiag=hdiag, hdiag_im=hdiag_im,
        sign_words=sign_words, coeff_re=coeff_re, coeff_im=coeff_im,
        is_complex=is_complex, has_diag=has_diag,
        packed_weights=(mode == "packed" and u_nd > 0), scan_matvec=scan,
    )
