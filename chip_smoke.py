# (C) 2026. Licensed under the Apache License, Version 2.0.
"""Smoke run of the SQD main path on the GPU, at the reference's full sizes.

    python chip_smoke.py               # one GPU: the five phases below
    python chip_smoke.py --four-cards  # four GPUs: the two sharded paths only

Every phase goes through the public entry points and is checked against a
plain reference:

* ``sqd_loop`` — N2/6-31G CAS(16o, (5,5)e) (integrals from ``sqd_tpu.chem``),
  ``diagonalize_fermionic_hamiltonian`` on synthetic uniform samples, 5
  batches x 300 samples, 5 iterations.  Gate: the host-NumPy f64 Rayleigh
  quotient of the returned amplitudes (1e-7 Ha) and the published CASCI
  energy as a variational bound (1e-6 Ha).
* ``solve_1e6`` — ``solve_sci`` on 1000 x 1000 excitation strings.  Gates:
  the host f64 Rayleigh quotient (1e-7 Ha) and one f32 matvec against a host
  f64 matvec of the same vector (relative 1e-5: a TF32 leak gives ~1e-3).
  Also times the cross-spin channel (32 chained matvecs in one program)
  against its memory/FLOP bound.
* ``casci_1p9e7`` — ``solve_sci`` on all 4368^2 determinants; gate: the
  published -109.046671778080 Ha (2e-6).
* ``dense_df_1e7`` — (54e, 36o), 3163^2 determinants, synthetic PSD
  integrals, ``solve_sci(matvec_strategy="dense_df")``.  Gates: one dense-DF
  f32 matvec against the f64 gather matvec (relative 1e-5), and the energy
  is finite and <= min(hdiag).
* ``pauli`` — Z^40 at d = 5e7 through ``pauli_term_table`` on the device
  against the host ``matrix_elements_from_pauli`` signs (exact), and
  ``solve_qubit_device`` on the L = 22 Heisenberg ring at d = 49,718
  against scipy/ARPACK ``solve_qubit`` (1e-8).

With ``--four-cards``: the batch solver over a 4-device mesh against the same
solver on one device (per-iteration energies, 1e-8 Ha), and the row-sharded
1e6 solve against ``solve_sci`` on one device (1e-7 Ha); every card must
have held memory.

Earlier lines print the card (``nvidia-smi``), the JAX version, the compile
cache directory, whether the native host library loaded, and one line per
phase and per check.  The last line is one JSON object.  Without a GPU the
script exits nonzero before printing any result; a failed check or phase
exits 1.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
N2_631G_CASCI_TOTAL = -109.046671778080  # integrate_dice_solver.ipynb cell 1


# --------------------------------------------------------------------------
# device and card
# --------------------------------------------------------------------------


def require_gpu(count: int = 1):
    """The JAX devices, or ``SystemExit`` when they are not ``count`` GPUs."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found {devices[0].platform!r}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, JAX found {len(devices)}")
    return devices


def parse_card_lines(text: str) -> list[tuple[str, str]]:
    """``(name, power_limit)`` per line of ``nvidia-smi --query-gpu=name,power.limit``."""
    cards = []
    for line in text.strip().splitlines():
        name, _, limit = line.rpartition(",")
        if name:
            cards.append((name.strip(), limit.strip()))
    return cards


def card_text() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# --------------------------------------------------------------------------
# checks and timing
# --------------------------------------------------------------------------


def check(name: str, err: float, limit: float) -> dict:
    err = float(err)
    return {"check": name, "err": err, "limit": limit, "ok": bool(err <= limit)}


def rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def cold_warm(fn):
    """Run ``fn`` twice; ``(second result, cold seconds, warm seconds)``."""
    t0 = time.perf_counter()
    fn()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn()
    return out, cold, time.perf_counter() - t0


def _pack(strs, norb):
    from sqd_tpu.ops import bitpack

    return bitpack.pack_ints(np.asarray(strs), norb)


def _padded(strs_a, strs_b, pad_bucket=32):
    up = lambda x: -(-x // pad_bucket) * pad_bucket  # noqa: E731
    return up(len(strs_a)), up(len(strs_b))


def _energy_checks(res, h1, eri, norb, nelec, e_limit):
    """Host f64 Rayleigh quotient of a result's amplitudes vs its energy."""
    import jax.numpy as jnp

    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu.ops.host_oracle import host_rayleigh_quotient

    st = res.sci_state
    ham64 = build_sci_hamiltonian(
        _pack(st.ci_strs_a, norb), _pack(st.ci_strs_b, norb), h1, eri, norb, nelec,
        dtype=jnp.float64,
    )
    e_host = host_rayleigh_quotient(ham64, st.amplitudes)
    return check("energy_vs_host_f64", abs(res.energy - e_host), e_limit)


# --------------------------------------------------------------------------
# phases (parameters default to the full sizes)
# --------------------------------------------------------------------------


def phase_sqd_loop(
    integrals, norb=16, nelec=(5, 5), e_exact=N2_631G_CASCI_TOTAL,
    samples_per_batch=300, num_batches=5, max_iterations=5, shots=100_000,
):
    from sqd_tpu.counts import generate_bit_array_uniform
    from sqd_tpu.fermion import diagonalize_fermionic_hamiltonian

    h1, eri, ecore = integrals
    bit_array = generate_bit_array_uniform(shots, 2 * norb, rand_seed=24)

    def run():
        return diagonalize_fermionic_hamiltonian(
            h1, eri, bit_array, samples_per_batch=samples_per_batch, norb=norb,
            nelec=nelec, num_batches=num_batches, max_iterations=max_iterations,
            symmetrize_spin=True, carryover_threshold=1e-4, seed=25,
        )

    res, cold, warm = cold_warm(run)
    e_tot = res.energy + ecore
    checks = [
        _energy_checks(res, h1, eri, norb, nelec, 1e-7),
        check("variational_vs_exact", e_exact - e_tot, 1e-6),
    ]
    info = {"energy_total": e_tot, "dim": int(np.prod(res.sci_state.amplitudes.shape))}
    return cold, warm, checks, info


def cross_spin_seconds(ham32, chain: int = 32) -> float:
    """Seconds per cross-spin product, ``chain`` data-dependent ones in one jit."""
    import jax
    import jax.numpy as jnp

    m, n = ham32.shape
    npair = ham32.norb * ham32.norb

    @jax.jit
    def chained(ham, c):
        def body(_, c):
            with jax.default_matmul_precision("highest"):
                d_a = ham.gather_alpha(c).reshape(npair, m * n)
                g = jnp.matmul(ham.eri_t, d_a, preferred_element_type=jnp.float32)
                s = ham.scatter_beta(g.reshape(npair, m, n))
            return s / jnp.linalg.norm(s)

        return jnp.sum(jax.lax.fori_loop(0, chain, body, c))

    c = jnp.full((m, n), 1.0 / np.sqrt(m * n), jnp.float32)
    float(chained(ham32, c))  # compile
    t0 = time.perf_counter()
    float(chained(ham32, c))
    return (time.perf_counter() - t0) / chain


# Published peaks per device kind: (float32 FLOP/s outside the tensor cores,
# device-memory bytes/s).  NVIDIA H100 SXM data sheet, dense rates at the
# full 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": (67e12, 3.35e12),
}


def cross_spin_bound_seconds(npair, m, n, peaks):
    """Least time of one f32 cross-spin product at the given peaks.

    FLOPs: the ``(npair, npair) @ (npair, M*N)`` pair matmul in plain f32.
    Bytes: D = E^a c written and read, G written and read.
    """
    flops_per_s, bytes_per_s = peaks
    flops = 2.0 * npair * npair * m * n
    nbytes = 4.0 * npair * m * n * 4
    return max(flops / flops_per_s, nbytes / bytes_per_s)


def precision_probe(npair=256, cols=1 << 20, chain=8) -> dict:
    """Relative error and time of the pair matmul at each precision.

    ``(npair, npair) @ (npair, cols)`` with random f32 operands against the
    host f64 product: ``default`` lets the GPU use TF32, ``highest`` is the
    plain-f32 tier every solver matmul pins, ``f64`` the native f64 product.
    The time is per product over ``chain`` data-dependent products in one jit.
    """
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(8)
    a = (rng.normal(size=(npair, npair)) / np.sqrt(npair)).astype(np.float32)
    b = rng.normal(size=(npair, cols)).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    out = {}
    for name, dt, prec in (
        ("default", jnp.float32, "default"),
        ("highest", jnp.float32, "highest"),
        ("f64", jnp.float64, "highest"),
    ):
        x, y = jnp.asarray(a, dt), jnp.asarray(b, dt)

        @jax.jit
        def chained(x, y, prec=prec):
            body = lambda _, z: jnp.matmul(x, z, precision=prec)  # noqa: E731
            return jnp.sum(jax.lax.fori_loop(0, chain, body, y))

        got = jax.jit(lambda x, y, prec=prec: jnp.matmul(x, y, precision=prec))(x, y)
        err = rel_err(got, ref)
        del got
        float(chained(x, y))  # compile
        t0 = time.perf_counter()
        float(chained(x, y))
        out[name] = {"rel_err": err, "ms": (time.perf_counter() - t0) * 1e3 / chain}
    return out


def phase_solve_1e6(integrals, norb=16, nelec=(5, 5), dim_a=1000, dim_b=1000, time_chain=32):
    import jax
    import jax.numpy as jnp

    from bench import excitation_strings
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian
    from sqd_tpu.ops.host_oracle import host_matvec, host_rayleigh_quotient

    h1, eri, _ = integrals
    strs_a = excitation_strings(dim_a, norb, nelec[0], 1)
    strs_b = excitation_strings(dim_b, norb, nelec[1], 2)

    res, cold, warm = cold_warm(
        lambda: solve_sci((strs_a, strs_b), h1, eri, norb=norb, nelec=nelec)
    )
    # the operator exactly as solve_sci builds it (same padding)
    ham64 = build_sci_hamiltonian(
        _pack(strs_a, norb), _pack(strs_b, norb), h1, eri, norb, nelec,
        dtype=jnp.float64, pad_to=_padded(strs_a, strs_b),
    )
    e_host = host_rayleigh_quotient(ham64, res.sci_state.amplitudes)
    ham32 = ham64.astype(jnp.float32)
    v = np.zeros(ham64.shape)
    v[: len(strs_a), : len(strs_b)] = np.random.default_rng(3).normal(size=(len(strs_a), len(strs_b)))
    sig32 = jax.jit(lambda h, x: h.matvec(x))(ham32, jnp.asarray(v, jnp.float32))
    checks = [
        check("energy_vs_host_f64", abs(res.energy - e_host), 1e-7),
        check("f32_matvec_vs_host_f64", rel_err(sig32, host_matvec(ham64, v)), 1e-5),
    ]
    m, n = ham32.shape
    info = {"energy": res.energy, "dim": len(strs_a) * len(strs_b), "padded_shape": [m, n]}
    if time_chain:
        info["matmul_precision"] = precision_probe(norb * norb, m * n)
        t = cross_spin_seconds(ham32, time_chain)
        info["cross_spin_ms"] = t * 1e3
        kind = jax.devices()[0].device_kind
        if kind in PEAKS:  # no default peaks: an unknown card gets no bound
            bound = cross_spin_bound_seconds(norb * norb, m, n, PEAKS[kind])
            info.update(cross_spin_bound_ms=bound * 1e3, cross_spin_share_of_bound=bound / t)
        else:
            info["cross_spin_bound_ms"] = f"no peaks for {kind!r}"
    return cold, warm, checks, info


def phase_casci(integrals, norb=16, nelec=(5, 5), e_exact=N2_631G_CASCI_TOTAL, limit=2e-6):
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.ops.dense_fci import all_hamming_strings

    h1, eri, ecore = integrals
    strs = all_hamming_strings(norb, nelec[0])
    res, cold, warm = cold_warm(
        lambda: solve_sci((strs, strs), h1, eri, norb=norb, nelec=nelec, with_rdms=False)
    )
    e_tot = res.energy + ecore
    checks = [check("energy_vs_published", abs(e_tot - e_exact), limit)]
    info = {"energy_total": e_tot, "dim": len(strs) ** 2,
            "f64_energy_eval_s": _f64_energy_seconds(strs, h1, eri, norb, nelec)}
    return cold, warm, checks, info


def _f64_energy_seconds(strs, h1, eri, norb, nelec) -> float:
    """Warm seconds of one ``expectation_value`` (the final f64 energy)."""
    import jax.numpy as jnp

    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian, expectation_value

    packed = _pack(strs, norb)
    ham64 = build_sci_hamiltonian(packed, packed, h1, eri, norb, nelec, dtype=jnp.float64,
                                  pad_to=_padded(strs, strs))
    v = jnp.ones(ham64.dim, jnp.float64)
    float(expectation_value(ham64, v))  # compile
    t0 = time.perf_counter()
    float(expectation_value(ham64, v))
    return time.perf_counter() - t0


def phase_dense_df(norb=36, nelec=(27, 27), dim=3163):
    import jax.numpy as jnp

    from bench import excitation_strings, synthetic_psd_integrals
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.ops.dense_df import densify
    from sqd_tpu.ops.hamiltonian import build_sci_hamiltonian

    h1, eri = synthetic_psd_integrals(norb)
    strs = excitation_strings(dim, norb, nelec[0], 1)

    res, cold, warm = cold_warm(
        lambda: solve_sci(
            (strs, strs), h1, eri, norb=norb, nelec=nelec,
            matvec_strategy="dense_df", refine_iterations=0, with_rdms=False,
        )
    )
    packed = _pack(strs, norb)
    ham64 = build_sci_hamiltonian(
        packed, packed, h1, eri, norb, nelec, dtype=jnp.float64,
        pad_to=_padded(strs, strs),
    )
    op = densify(ham64, dtype=jnp.float32)
    v = np.zeros(ham64.shape)
    v[:dim, :dim] = np.random.default_rng(4).normal(size=(dim, dim))
    sig_df = op.matvec(jnp.asarray(v, jnp.float32))
    sig64 = ham64.matvec(jnp.asarray(v))
    hd = np.asarray(ham64.hdiag)[:dim, :dim]
    checks = [
        check("dense_df_f32_matvec_vs_f64_gather", rel_err(sig_df, sig64), 1e-5),
        check("energy_finite", 0.0 if np.isfinite(res.energy) else np.inf, 0.0),
        check("energy_minus_min_hdiag", res.energy - float(hd.min()), 0.0),
    ]
    return cold, warm, checks, {"energy": res.energy, "dim": dim * dim}


def phase_pauli(nq=40, d=50_000_000, ring=22, d_ring=49_718):
    import jax.numpy as jnp

    from bench import random_packed
    from sqd_tpu import qubit
    from sqd_tpu.models.heisenberg import heisenberg_ring
    from sqd_tpu.ops import bitpack
    from sqd_tpu.ops.pauli_proj import pauli_term_table
    from sqd_tpu.primitives import Pauli

    packed = random_packed(nq, d, 3)
    pz = Pauli.from_label("Z" * nq)
    packed_dev = jnp.asarray(packed)
    op = heisenberg_ring(ring, j_xx=1.0, j_yy=1.0, j_zz=1.0, h_z=0.1)
    ints = np.unique(np.random.default_rng(5).integers(0, 1 << ring, size=2 * d_ring))[:d_ring]
    bits = bitpack.unpack_to_bool_matrix(ints.astype(np.uint32)[:, None], ring)

    def run():
        _, sign, _ = pauli_term_table(packed_dev, pz)
        e_dev, _, _ = qubit.solve_qubit_device(bits, op)
        return np.asarray(sign), float(e_dev)

    (sign_dev, e_dev), cold, warm = cold_warm(run)
    amps, _, _ = qubit.matrix_elements_from_pauli(packed, pz)
    sign_host = np.real(amps).astype(np.int64)  # phase = 1 for a Z string
    e_host = float(qubit.solve_qubit(bits, op, k=1, which="SA")[0][0])
    checks = [
        check("z_signs_mismatched", np.count_nonzero(sign_dev.astype(np.int64) != sign_host), 0),
        check("qubit_energy_vs_arpack", abs(e_dev - e_host), 1e-8),
    ]
    return cold, warm, checks, {"d_pauli": int(len(packed)), "d_ring": int(len(bits)), "energy": e_dev}


def phase_batch_sharded(integrals, devices, norb=16, nelec=(5, 5), num_batches=4,
                        samples_per_batch=300, max_iterations=5, shots=100_000):
    """The SQD loop through the batch solver on a 4-device mesh vs one device.

    Both runs iterate in f64, so the comparison sees the sharding and not
    the f32 noise of two differently batched Davidson runs.
    """
    import functools

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sqd_tpu.counts import generate_bit_array_uniform
    from sqd_tpu.fermion import diagonalize_fermionic_hamiltonian
    from sqd_tpu.parallel.batch_solver import solve_sci_batch_sharded

    h1, eri, _ = integrals
    bit_array = generate_bit_array_uniform(shots, 2 * norb, rand_seed=24)

    def sqd(devs):
        history = []
        diagonalize_fermionic_hamiltonian(
            h1, eri, bit_array, samples_per_batch=samples_per_batch, norb=norb,
            nelec=nelec, num_batches=num_batches, max_iterations=max_iterations,
            symmetrize_spin=True, carryover_threshold=1e-4, seed=25,
            sci_solver=functools.partial(
                solve_sci_batch_sharded, mesh=Mesh(np.array(devs), ("batch",)),
                solver_dtype=jnp.float64,
            ),
            callback=lambda rs: history.append([r.energy for r in rs]),
        )
        return np.array(history)

    t0 = time.perf_counter()
    e_mesh = sqd(devices)
    seconds = time.perf_counter() - t0
    e_one = sqd(devices[:1])
    err = np.max(np.abs(e_mesh - e_one)) if e_mesh.shape == e_one.shape else np.inf
    checks = [check("iteration_energies_mesh_vs_one_device", err, 1e-8)]
    return seconds, None, checks, {"iterations": len(e_mesh), "devices": len(devices)}


def phase_rowsharded(integrals, devices, norb=16, nelec=(5, 5), dim_a=1000, dim_b=1000):
    """One solve with the determinant axis sharded over the mesh vs ``solve_sci``."""
    from jax.sharding import Mesh

    from bench import excitation_strings
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.parallel.row_sharded import solve_sci_rowsharded

    h1, eri, _ = integrals
    strs_a = excitation_strings(dim_a, norb, nelec[0], 1)
    strs_b = excitation_strings(dim_b, norb, nelec[1], 2)
    mesh = Mesh(np.array(devices), ("row",))
    t0 = time.perf_counter()
    rows = solve_sci_rowsharded((strs_a, strs_b), h1, eri, norb, nelec, mesh=mesh)
    seconds = time.perf_counter() - t0
    single = solve_sci((strs_a, strs_b), h1, eri, norb=norb, nelec=nelec, with_rdms=False)
    checks = [check("energy_mesh_vs_one_device", abs(rows.energy - single.energy), 1e-7)]
    return seconds, None, checks, {"energy": rows.energy, "devices": len(devices)}


def phase_memory(devices):
    """Every device must have held memory (``peak_bytes_in_use`` > 0)."""
    stats = [dv.memory_stats() or {} for dv in devices]
    in_use = [int(s.get("bytes_in_use", 0)) for s in stats]
    peak = [int(s.get("peak_bytes_in_use", 0)) for s in stats]
    checks = [check("devices_without_memory", sum(p == 0 for p in peak), 0)]
    return None, None, checks, {"bytes_in_use": in_use, "peak_bytes_in_use": peak}


# --------------------------------------------------------------------------
# entry point
# --------------------------------------------------------------------------


def run_phase(name, fn, *args, **kwargs) -> bool:
    """Run one phase, print its lines; False when it raised or a check failed."""
    try:
        cold, warm, checks, info = fn(*args, **kwargs)
    except Exception:  # reported and failed below, never swallowed
        traceback.print_exc()
        print(f"phase={name} ok=False error=exception", flush=True)
        return False
    ok = all(c["ok"] for c in checks)
    print(f"phase={name} cold_s={cold} warm_s={warm} ok={ok} info={json.dumps(info)}", flush=True)
    for c in checks:
        print(f"  check={c['check']} err={c['err']} limit={c['limit']} ok={c['ok']}", flush=True)
    return ok


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded paths, on four GPUs")
    args = parser.parse_args(argv)
    devices = require_gpu(4 if args.four_cards else 1)

    import jax

    from sqd_tpu import native
    from sqd_tpu.utils.compile_cache import configure_compile_cache

    cache = configure_compile_cache(os.path.join(REPO, ".jax_cache_gpu"))
    print(card_text(), flush=True)
    print(f"jax={jax.__version__} compile_cache={cache} native_host_library={native.available()}",
          flush=True)
    from bench import n2_631g_cas

    t0 = time.perf_counter()
    integrals = n2_631g_cas()
    print(f"integrals_s={time.perf_counter() - t0}", flush=True)
    if args.four_cards:
        devices = devices[:4]
        results = [
            run_phase("batch_sharded_4", phase_batch_sharded, integrals, devices),
            run_phase("rowsharded_4", phase_rowsharded, integrals, devices),
            run_phase("memory_4", phase_memory, devices),
        ]
    else:
        results = [
            run_phase("sqd_loop", phase_sqd_loop, integrals),
            run_phase("solve_1e6", phase_solve_1e6, integrals),
            run_phase("casci_1p9e7", phase_casci, integrals),
            run_phase("dense_df_1e7", phase_dense_df),
            run_phase("pauli", phase_pauli),
        ]
    dev = jax.devices()[0]
    ok = all(results)
    print(json.dumps({"ok": ok, "device": {"platform": dev.platform, "kind": dev.device_kind,
                                           "count": len(devices)}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
