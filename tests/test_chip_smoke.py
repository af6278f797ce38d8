"""chip_smoke.py's checks: on the CPU at a cut size (every phase's check
logic, the multi-card comparison on a virtual mesh, and the refusal to
run without a card), and at full size on the card (``gpu`` marker)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import __graft_entry__ as g
import chip_smoke as cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("case", [0, 1], ids=["tiny_spec", "cc11xx-small"])
def test_block_graph_matches_reference_small(case):
    name, spec, fc, rr = cs.phase_b_specs(small=True)[case]
    mod = cs.modulator_for(spec, fc)
    payload = np.random.RandomState(5).randint(0, 256, 8).astype(np.uint8)
    block, span = cs.burst_block(spec, mod, payload, rr, seed=11)
    r = cs.check_block_vs_reference(spec, block, span)
    assert r["mags_rel_err"] <= cs.MAGS_RTOL and r["burst_slots"] > 16


def test_reference_check_catches_a_wrong_doppler_bin(monkeypatch):
    """The phase (b) comparison fails when the reference saw another
    Doppler offset (a check that cannot fail proves nothing)."""
    import pycusdr_tpu.dsp.reference as ref

    name, spec, fc, rr = cs.phase_b_specs(small=True)[1]
    mod = cs.modulator_for(spec, fc)
    payload = np.random.RandomState(5).randint(0, 256, 8).astype(np.uint8)
    block, span = cs.burst_block(spec, mod, payload, rr, seed=11)
    other, _ = cs.burst_block(spec, mod, payload, -rr, seed=11)
    real = ref.demod_block_numpy
    monkeypatch.setattr(ref, "demod_block_numpy", lambda sp, _x: real(sp, other))
    with pytest.raises(cs.CheckFailed, match="Doppler bin"):
        cs.check_block_vs_reference(spec, block, span)


def test_dispatch_identity_checks_small():
    cs.phase_c(cs.cc11xx_conf(small=True))


def test_modem_loop_small():
    cs.phase_d(cs.cc11xx_conf(small=True), n_packets=8)


def test_four_card_phase_on_virtual_mesh():
    """The --four-cards comparisons at tiny shapes on four of the test
    session's virtual CPU devices."""
    cs.four_card_phase(g.tiny_spec(), g.tiny_spec(mask_size=5), jax.devices())


def test_refuses_to_run_without_a_card():
    """No NVIDIA card: non-zero exit and no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=120, env=env, cwd=ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_gpu_block_graph_matches_reference():
    cs.phase_b()


@pytest.mark.gpu
def test_gpu_dispatch_identity():
    cs.phase_c(cs.cc11xx_conf())


@pytest.mark.gpu
def test_gpu_modem_loop():
    cs.phase_d(cs.cc11xx_conf())
