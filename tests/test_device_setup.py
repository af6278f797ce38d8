"""Device set-up that every entry point shares: the persistent compile
cache, each demod child's share of the card's memory, and the imports
the in-process main path needs on the card's host."""

import os
import subprocess
import sys

import jax
import pytest

from pycusdr_tpu.utils.device_info import DEFAULT_CACHE_DIR, configure_compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_env_wins_over_config(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    env_dir = str(tmp_path / "env_cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env_dir)
    assert configure_compile_cache(str(tmp_path / "config_cache")) == env_dir
    assert configure_compile_cache(None) == env_dir
    # nothing here set another directory
    assert jax.config.jax_compilation_cache_dir == before
    assert not (tmp_path / "config_cache").exists()


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch, tmp_path):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert DEFAULT_CACHE_DIR == os.path.join(ROOT, ".xla_cache")
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".xla_cache/" in f.read().split()
    # off on the CPU backend unless a directory is configured
    assert configure_compile_cache(None) is None
    assert configure_compile_cache("") is None
    before = jax.config.jax_compilation_cache_dir
    try:
        d = str(tmp_path / "configured")
        assert configure_compile_cache(d) == d
        assert jax.config.jax_compilation_cache_dir == d and os.path.isdir(d)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_demod_memory_fraction():
    from pycusdr_tpu.runtime.orchestrator import demod_memory_fraction

    assert demod_memory_fraction(1) is None
    assert demod_memory_fraction(2) == pytest.approx(0.45)
    assert demod_memory_fraction(4) == pytest.approx(0.225)


@pytest.mark.parametrize("rss_cap,share", [(0, "0.300"), (4000, "0.225")])
def test_orchestrator_gives_each_demod_child_its_share(rss_cap, share):
    """Three Rx radios on one card (plus, with the RSS cap, the
    planned-restart replacement): every demod child, and a replacement
    built by its factory, carries the same memory share."""
    from pycusdr_tpu.config.loader import load_modular_json
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = load_modular_json(os.path.join(
        ROOT, "pycusdr_tpu", "config", "configs", "benchmark", "bench_3_chan_rx.json"))
    conf["Main"]["maxWorkerRssMb"] = rss_cap
    conf["RPC"] = {"enabled": False}
    from pycusdr_tpu.utils.logger import shutdown_logging

    sdr = PyCuSDR(conf, args=None)
    try:
        demods = sdr.demodulators
        assert len(demods) == 3
        for d in demods:
            assert d.device_env() == {"XLA_PYTHON_CLIENT_MEM_FRACTION": share}
        i = sdr.tasks.index(demods[0])
        assert sdr._task_factories[i]().device_env() == demods[0].device_env()
    finally:
        shutdown_logging()


def test_lone_demod_child_keeps_jax_default():
    from pycusdr_tpu.runtime.demodulator_process import Demodulator_process
    from pycusdr_tpu.config.loader import load_modular_json
    from pycusdr_tpu.protocol import loadProtocol

    conf = load_modular_json(os.path.join(
        ROOT, "pycusdr_tpu", "config", "configs", "CC11xx.json"))
    proc = Demodulator_process(conf, loadProtocol("CC11xx")(conf=conf), "UHF-H")
    assert proc.device_env() == {}


def test_main_path_imports_without_process_layer_packages():
    """What chip_smoke.py phases (a)-(d) reach imports none of zmq,
    psutil or matplotlib at module level (the card's host may lack
    them)."""
    code = """
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("zmq", "psutil", "matplotlib"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
import chip_smoke, __graft_entry__
import pycusdr_tpu.models.uhf, pycusdr_tpu.decode, pycusdr_tpu.dsp.block
import pycusdr_tpu.dsp.reference, pycusdr_tpu.tx.modulator, pycusdr_tpu.protocol.cc11xx
import pycusdr_tpu.parallel, pycusdr_tpu.utils.device_info, pycusdr_tpu.config.loader
bad = [m for m in sys.modules if m.split(".")[0] in ("zmq", "psutil", "matplotlib")]
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=env)
    assert p.returncode == 0 and p.stdout.strip().endswith("ok"), p.stderr[-2000:]
