"""Global constants and small config helpers.

Capability parity with the reference's ``pyCuSDR/__global__.py:15-64``:
trust/data dtypes, modulator dtype, benchmark/debug switches, a
defaults-with-warning config lookup and hex pretty printers.
"""

import logging
import string

import numpy as np

LOG_NAME = "pycusdr_tpu"
log = logging.getLogger(LOG_NAME + "." + __name__)

# In benchmark mode only packets from one channel are forwarded to the
# link manager (see decode.decoder_process).
BENCHMARK_MODE = False

SAVETX_DATA = False  # Tx: snapshot the last modulated waveform to .npy
STORE_BITS_IN_FILE = False  # Rx: dump demodulated bits (slow, debug only)

# Trust semantics (int8):
#   normal bit        : +2 * voteWeight
#   symbol error      : -1
#   clipped RFI burst : -2
TRUSTTYPE = np.int8
DATATYPE = np.int8

TRUST_NORMAL_SCALE = 2


def apply_platform_override():
    """Honour the ``PYCUSDR_JAX_PLATFORM`` env var (e.g. ``cpu``).

    Spawned device workers (runtime/demodulator_process.py,
    runtime/channel_group_process.py) call this before their first
    device use so tests and CPU deployments can force a backend. Raises
    when the platform can no longer be set (a backend is already up).
    """
    import os

    plat = os.environ.get("PYCUSDR_JAX_PLATFORM")
    if plat:
        import jax

        jax.config.update("jax_platforms", plat)
        got = jax.default_backend()
        if got != {"cuda": "gpu", "rocm": "gpu"}.get(plat, plat):
            raise RuntimeError(
                f"PYCUSDR_JAX_PLATFORM={plat!r} not applied: JAX's backend is {got!r}")


def pin_host_stage_to_cpu():
    """Keep a host-stage process (decoder, combiner, modulator) off the
    accelerator: any JAX it imports (e.g. the CCSDS Viterbi) runs on the
    CPU, so only the demodulator processes open the card. Call first
    thing in the child's ``run()``."""
    import os
    import sys

    os.environ["JAX_PLATFORMS"] = "cpu"
    if "jax" in sys.modules:
        sys.modules["jax"].config.update("jax_platforms", "cpu")


TRUST_SYMBOL_ERROR = -1
TRUST_CLIPPED = -2

MODULATORDTYPE = np.complex64

printableChars = set(string.printable)


def printBytesAsHex(data) -> str:
    """'DE AD BE EF' style hex dump of an iterable of byte values."""
    return " ".join("{:02X}".format(int(b) & 0xFF) for b in data)


def attr_in_config(cfg: dict, attr: str, defaultVal, warningOnFail: bool = True):
    """Return ``cfg[attr]`` or ``defaultVal`` with an optional warning."""
    if attr in cfg:
        return cfg[attr]
    if warningOnFail:
        log.warning("'%s' not specified in config. Using default value of %s", attr, defaultVal)
    return defaultVal


def json_str_list_to_int_list(json_list, base: int = 16):
    """Convert a list of numeric strings (hex by default) to ints."""
    return [int(k, base) for k in json_list]
