"""pycusdr_tpu — a JAX software-defined-radio modem framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of pyCuSDR
(GPU satellite ground-station modem, reference: /root/reference):

* real-time Doppler search + correction via banks of matched filters
  (frequency-domain correlation as one dense contraction instead of batched
  lag-domain IFFTs — see ``pycusdr_tpu.ops.doppler_search``),
* symbol-rate / symbol-timing recovery and soft-bit demodulation,
* multi-channel diversity combining by trust-weighted bit voting,
* preamble/sync packet detection, PN9 de-whitening, CRC-16 and
  Reed-Solomon decoding,
* a transmit chain (framing, whitening, CRC, FSK/GFSK/GMSK LUT
  modulators with Doppler pre-compensation),
* ZMQ edge interfaces (GNU Radio IQ in/out), XML-RPC control plane and
  a hamlib-compatible rig server for gpredict,
* multi-chip scaling via ``jax.sharding`` meshes (channels / Doppler
  bins / time-blocks sharded over the devices with halo exchange).

Layer map (mirrors SURVEY.md §1 of the reference analysis):

=========  ====================================================
subpkg     role
=========  ====================================================
ops        device ops in jnp/lax (the performance core)
dsp        block-level demod algorithm: jitted graph + numpy golden
models     radio-backend demodulator frontends (UHF, STX)
protocol   protocol plug-ins (CC11xx + benchmark modulations)
decode     frame finding, packet codecs, dedup, RS FEC
tx         framers + LUT modulators
combine    softCombiner diversity voting
runtime    streaming host loop, ZMQ ingest, orchestrator
control    XML-RPC + hamlib rig control plane
obs        stats, visualisation, metrics export
parallel   device-mesh sharding, halo exchange, channelizer
utils      filters, shift registers, CRC, conversions, logging
config     modular JSON config system + shipped configs
native     C++ host runtime (ring buffer, bit ops) via ctypes
=========  ====================================================
"""

__version__ = "0.1.0"

LOG_NAME = "pycusdr_tpu"

from pycusdr_tpu.globals import (  # noqa: F401
    TRUSTTYPE,
    DATATYPE,
    MODULATORDTYPE,
    attr_in_config,
)


def PyCuSDR(*args, **kwargs):
    """Lazy re-export of the orchestrator (runtime.orchestrator.PyCuSDR)."""
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR as _P

    return _P(*args, **kwargs)
