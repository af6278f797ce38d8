"""Test config: run JAX on CPU with 8 virtual devices so the full chain
(including multi-chip sharding tests) needs no accelerator.

Tests marked ``gpu`` run the on-card checks of ``chip_smoke.py``; they
skip (from a fixture, never at import) when JAX has no GPU. Run them on
the card with ``JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist``."""

import os

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax  # noqa: E402

# CPU unless the run names the card (the ``gpu``-marked tests)
if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped when JAX has none")


@pytest.fixture(autouse=True)
def _skip_without_gpu(request):
    """Skip ``gpu``-marked tests when JAX has no GPU (decided here, at
    run time, never while a module is imported)."""
    if request.node.get_closest_marker("gpu") and jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; JAX has " + jax.devices()[0].platform)


@pytest.fixture(scope="session")
def bench_conf():
    """Small benchmark-style config (CPU-test sized FFT)."""
    return {
        "Main": {
            "workerId": "test",
            "PacketLen": 10000,
            "RandSeed": 123,
            "softCombiner_enabled": False,
            "protocols": {"UHF": "bench_FSK"},
        },
        "GPU": {
            "UHF": {
                "blockSize": 13,
                "overlap": 10,
                "bitWindowWidth": 7,
                "xcorrMaskSize": 3,
                "clippedPeakSpan": 20,
                "peakThresholdScale": 40.5,
                "doppCarrierSteps": 16,
            }
        },
        "Radios": {
            "rangeRateMax": 7500,
            "Rx": {
                "UHF-H": {
                    "name": "UHF",
                    "CUDA_settings": "UHF",
                    "frequency_Hz": 437.3e6,
                    "frequencyOffset_Hz": 38400,
                    "baud": 9600,
                    "samplesPerSym": 16,
                    "doppCarrierSteps": 16,
                    "Protocol": "UHF",
                    "radioBackend": "UHF",
                    "voteGroup": "UHF",
                    "Interfaces": {
                        "RxInPort": "tcp://127.0.0.1:25560",
                        "demodOut": "tcp://localhost:20003",
                    },
                }
            },
        },
        "Demodulator": {"timeoutSeconds": 5},
        "SoftCombiner": {
            "processingInterval": 0.3,
            "pollingTimeout": 95,
            "workerTimeout": 20.0,
            "workerDataTimeout": 3.5,
            "varianceMultiplier": 15.0,
            "minProcessingLength": 1000,
            "workerDataRequestThreshold": 3,
            "masterVoteWeight": 1.2,
        },
        "decoder": {"packetCheckHist": 40, "packetCheckHistTimeout": 1},
        "Interfaces": {
            "External": {"decodeBytesOut_ZMQ": {"UHF": "tcp://*:25512"}},
            "Internal": {
                "demodIn": "tcp://*:20003",
                "demodOut": "tcp://localhost:20003",
                "decodeOut": "tcp://localhost:20004",
                "decodeIn": "tcp://*:20004",
            },
        },
        "LogInfo": {
            "demodulator_print_always": False,
            "demodulator_print_interval": 50,
            "demodulator_print_threshold_enabled": False,
            "demodulator_print_threshold_lvl": 12,
        },
    }


def make_fsk_signal(bits, spsym, offset_norm, amp=1.0, seed=0, noise_std=0.0):
    """FSK-modulate bits (π rad/symbol) and mix to offset_norm·fs.

    Mirrors examples/benchmark/create_signals.py:modulateFSK in the
    reference: phase ramp ±π per symbol, initial offset −(2b0−1)·π/2.
    """
    bits = np.asarray(bits)
    wave = np.ones(spsym) / spsym * np.pi
    lut = np.array([-wave, wave])
    phase = np.cumsum(lut[bits]) - (bits[0] * 2 - 1) * np.pi / 2
    sig = amp * np.exp(1j * phase)
    n = np.arange(len(sig))
    sig = sig * np.exp(1j * 2 * np.pi * offset_norm * n)
    if noise_std > 0:
        rng = np.random.RandomState(seed)
        sig = sig + noise_std / np.sqrt(2) * (rng.randn(len(sig)) + 1j * rng.randn(len(sig)))
    return sig.astype(np.complex64)


@pytest.fixture(scope="session")
def fsk_block(bench_conf):
    """A full FSK block (Nfft samples) with known bits at the IF offset."""
    from pycusdr_tpu.protocol import loadProtocol
    from pycusdr_tpu.dsp.spec import build_spec

    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    spec = build_spec(bench_conf, protocol, "UHF-H")

    nbits = spec.Nfft // int(spec.spsym)
    rng = np.random.RandomState(42)
    bits = rng.randint(0, 2, nbits)
    sig = make_fsk_signal(bits, int(spec.spsym), 38400 / spec.sampleRate)
    return spec, bits, sig
