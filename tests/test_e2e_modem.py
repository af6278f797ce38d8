"""End-to-end modem tests: modulated packet -> streamed overlap-save
blocks -> device demodulator -> frame finder -> bit-exact packet.

This is the in-process equivalent of the reference BER harness
(examples/benchmark/bench_modem.py) at high SNR: the decoded packet must
be bit-exact vs the seeded ground truth.
"""

import numpy as np
import pytest

from pycusdr_tpu.decode import Decoder
from pycusdr_tpu.dsp.signal_gen import awgn, get_padded_packet, packet_data
from pycusdr_tpu.models import UHF
from pycusdr_tpu.protocol import loadProtocol


def run_modem_stream(conf, protocol_name, sig, radio="UHF-H"):
    """Stream sig through demod blocks + decoder; return decoded packets."""
    protocol = loadProtocol(protocol_name)(conf=conf)
    demod = UHF.Demodulator(conf, protocol, radio)
    decoder = Decoder(conf, protocol)

    blockSize = demod.Nfft
    overlap = demod.sigOverlap
    step = blockSize - overlap
    raw = demod.get_signalBufferHostPointer()

    # flush: pad with zeros to a whole number of blocks so the tail of
    # the signal is demodulated (the reference harness appends 2^17
    # zeros for the same reason, create_signals.py:251-253)
    n_blocks = int(np.ceil(len(sig) / step)) + 1
    sig = np.r_[sig, np.zeros(n_blocks * step - len(sig) + step, dtype=np.complex64)]

    packets = []
    pos = 0
    while pos + step <= len(sig):
        raw[overlap:] = sig[pos : pos + step]
        demod.uploadAndFindCarrier(raw)
        bits, centres, trust, spSymEst = demod.demodulate()
        pkts, _, _ = decoder.findFrames(bits, 0)
        packets.extend(pkts)
        raw[:overlap] = raw[-overlap:]
        pos += step
    return packets, protocol


@pytest.mark.parametrize("modulation,protocol_name", [
    ("FSK", "bench_FSK"),
    ("GFSK", "bench_GFSK"),
    ("GMSK", "bench_GMSK"),
])
def test_e2e_clean_packet(bench_conf, modulation, protocol_name):
    """A clean packet at the IF offset decodes bit-exact."""
    conf = dict(bench_conf)
    conf["Main"] = dict(conf["Main"], PacketLen=1000, protocols={"UHF": protocol_name})

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    sig, _ = get_padded_packet(modulation, 16, fs, offset_freq=38400, raw_bits=bits, pad=6000)

    packets, protocol = run_modem_stream(conf, protocol_name, sig)
    assert len(packets) >= 1, f"{modulation}: no packet decoded"
    errs = [p.checkPacketData() for p in packets]
    assert min(errs) == 0, f"{modulation}: best packet has {min(errs)} bit errors"


def test_e2e_moderate_noise(bench_conf):
    """FSK at moderate SNR still decodes with low BER."""
    conf = dict(bench_conf)
    conf["Main"] = dict(conf["Main"], PacketLen=1000, protocols={"UHF": "bench_FSK"})

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    sig, _ = get_padded_packet("FSK", 16, fs, offset_freq=38400, raw_bits=bits, pad=6000)
    rng = np.random.RandomState(11)
    bw_fsk = 2 * 9600 + 9600  # cf. bench_modem.py bandwidth accounting
    snr = 15 + 10 * np.log10(bw_fsk / fs)
    sig = awgn(sig, snr, rng=rng).astype(np.complex64)

    packets, protocol = run_modem_stream(conf, "bench_FSK", sig)
    assert len(packets) >= 1
    errs = min(p.checkPacketData() for p in packets)
    assert errs <= 10, f"BER too high at 15 dB: {errs}/1000"


def test_e2e_bpsk_nrzs_packet(bench_conf):
    """BPSK with NRZ-S phase-ambiguity resolution through the full
    modem loop (the 4th reference benchmark modulation)."""
    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["Main"] = dict(conf["Main"], PacketLen=1000, protocols={"UHF": "bench_BPSK"})
    conf["GPU"] = {"UHF": dict(conf["GPU"]["UHF"], xcorrMaskSize=4)}

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    sig, _ = get_padded_packet("BPSK", 16, fs, offset_freq=38400, raw_bits=bits, pad=6000)

    packets, protocol = run_modem_stream(conf, "bench_BPSK", sig)
    assert len(packets) >= 1, "BPSK: no packet decoded"
    errs = [p.checkPacketData() for p in packets]
    assert min(errs) <= 2, f"BPSK: best packet has {min(errs)} bit errors"
