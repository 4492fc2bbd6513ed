# (C) 2026. Licensed under the Apache License, Version 2.0.
"""chip_smoke.py on the CPU: its device check, helpers, and every phase at toy size.

The script itself refuses to run without a GPU; its phase functions take
their sizes as arguments, so the same code paths and gates run here on small
problems whose exact answers are known.
"""

import numpy as np
import pytest

import jax

import chip_smoke
from sqd_tpu.utils.compile_cache import ENV_VAR, compile_cache_dir


@pytest.fixture(scope="module")
def n2_sto3g():
    """N2/STO-3G CAS(8o, (5,5)e) integrals and its exact CASCI total energy."""
    from sqd_tpu.chem import Molecule, active_space_integrals, rhf
    from sqd_tpu.fermion import solve_sci
    from sqd_tpu.ops.dense_fci import all_hamming_strings

    mol = Molecule([("N", (0.0, 0.0, 0.0)), ("N", (0.0, 0.0, 1.09768))], basis="sto-3g")
    h1, eri, ecore = active_space_integrals(rhf(mol), ncas=8, nelecas=10)
    strs = all_hamming_strings(8, 5)
    exact = solve_sci((strs, strs), h1, eri, norb=8, nelec=(5, 5), tol=1e-10).energy + ecore
    return (h1, eri, ecore), exact


def _assert_ok(out):
    cold, warm, checks, info = out
    assert checks and all(c["ok"] for c in checks), checks
    return info


def test_require_gpu_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(SystemExit) as exc:
        chip_smoke.require_gpu()
    assert exc.value.code not in (0, None)
    assert "needs a GPU" in str(exc.value.code)


def test_main_exits_before_any_result_on_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir_placement(monkeypatch, tmp_path, env_set):
    default = tmp_path / "repo" / ".jax_cache_gpu"
    if env_set:
        monkeypatch.setenv(ENV_VAR, str(tmp_path / "elsewhere"))
        assert compile_cache_dir(str(default)) == (str(tmp_path / "elsewhere"), False)
    else:
        monkeypatch.delenv(ENV_VAR, raising=False)
        assert compile_cache_dir(str(default)) == (str(default), True)


@pytest.mark.parametrize(
    "text,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n", [("NVIDIA H100 80GB HBM3", "700.00 W")]),
        (
            "NVIDIA H100 80GB HBM3, 700.00 W\nNVIDIA H100 80GB HBM3, 500.00 W\n",
            [("NVIDIA H100 80GB HBM3", "700.00 W"), ("NVIDIA H100 80GB HBM3", "500.00 W")],
        ),
        ("", []),
    ],
)
def test_parse_card_lines(text, want):
    assert chip_smoke.parse_card_lines(text) == want


def test_cross_spin_bound():
    # 1e6 shape: 131 GFLOP of f32 matmul dominates 4.3 GB of traffic
    bound = chip_smoke.cross_spin_bound_seconds(256, 1024, 1024, (67e12, 3.35e12))
    assert bound == pytest.approx(2 * 256**2 * 1024**2 / 67e12)
    # memory-bound when the FLOP peak is huge
    bound = chip_smoke.cross_spin_bound_seconds(256, 1024, 1024, (1e30, 3.35e12))
    assert bound == pytest.approx(16 * 256 * 1024**2 / 3.35e12)


def test_check_and_rel_err():
    assert chip_smoke.check("x", 1e-9, 1e-8)["ok"]
    assert not chip_smoke.check("x", np.inf, 0.0)["ok"]
    assert chip_smoke.rel_err([1.0, 2.0], [1.0, 2.0]) == 0.0


def test_phase_sqd_loop_small(n2_sto3g):
    integrals, exact = n2_sto3g
    info = _assert_ok(chip_smoke.phase_sqd_loop(
        integrals, norb=8, e_exact=exact, samples_per_batch=40, num_batches=2,
        max_iterations=2, shots=3000,
    ))
    assert info["energy_total"] >= exact - 1e-6


def test_phase_solve_small(n2_sto3g):
    integrals, _ = n2_sto3g
    info = _assert_ok(chip_smoke.phase_solve_1e6(
        integrals, norb=8, dim_a=30, dim_b=25, time_chain=2,
    ))
    assert info["cross_spin_ms"] > 0 and "cpu" in info["cross_spin_bound_ms"]


def test_phase_casci_small(n2_sto3g):
    integrals, exact = n2_sto3g
    _assert_ok(chip_smoke.phase_casci(integrals, norb=8, e_exact=exact))


def test_phase_dense_df_small():
    _assert_ok(chip_smoke.phase_dense_df(norb=17, nelec=(8, 8), dim=40))


def test_phase_pauli_small():
    _assert_ok(chip_smoke.phase_pauli(d=20_000, ring=10, d_ring=300))


def test_phase_sharded_small(n2_sto3g):
    integrals, _ = n2_sto3g
    devices = jax.devices()[:4]
    _assert_ok(chip_smoke.phase_batch_sharded(
        integrals, devices, norb=8, samples_per_batch=30, max_iterations=2, shots=3000,
    ))
    _assert_ok(chip_smoke.phase_rowsharded(integrals, devices, norb=8, dim_a=32, dim_b=24))
    # the CPU backend keeps no allocator statistics: one check, reported
    _, _, checks, info = chip_smoke.phase_memory(devices)
    assert len(checks) == 1 and len(info["peak_bytes_in_use"]) == 4
