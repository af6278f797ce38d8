"""Streaming host runtime: the process layer and orchestrator.

The modem runs as a pipeline of OS processes connected by ZMQ, exactly
like the reference (SURVEY.md §1 L2/L3): IQ samples PUB/SUB in from
GNU Radio, soft-bit dicts PUSH/PULL between stages, decoded bytes PUSH
out, complex64 Tx waveforms PUSH back to GNU Radio. The accelerator is
used by exactly one stage (the demodulator), whose whole per-block computation
is one jitted graph (``dsp.block``) — multi-chip variants live in
``pycusdr_tpu.parallel``.
"""

from pycusdr_tpu.runtime.sigfifo import RingBuffer, SigFIFO  # noqa: F401
from pycusdr_tpu.runtime.demodulator_process import Demodulator_process  # noqa: F401
from pycusdr_tpu.runtime.decoder_process import Decoder  # noqa: F401
from pycusdr_tpu.runtime.modulator_process import Modulator_process  # noqa: F401
from pycusdr_tpu.runtime.orchestrator import PyCuSDR  # noqa: F401
