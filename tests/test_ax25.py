"""AX.25/HDLC protocol: bit-level codecs, frame codec roundtrip, FLAGS
frame finding from a bit stream, and the full modem loop."""

import numpy as np
import pytest

from pycusdr_tpu.protocol import loadProtocol
from pycusdr_tpu.protocol.ax25 import (
    FLAG,
    bit_destuff,
    bit_stuff,
    build_ui_frame,
    bytes_to_bits_lsb,
    crc16_x25,
    nrzi_decode,
    nrzi_encode,
)


class TestHdlcCodecs:
    def test_stuff_destuff_roundtrip(self):
        rng = np.random.RandomState(0)
        for _ in range(20):
            bits = rng.randint(0, 2, rng.randint(10, 400)).astype(np.uint8)
            np.testing.assert_array_equal(bit_destuff(bit_stuff(bits)), bits)

    def test_stuffing_breaks_flag_pattern(self):
        bits = np.ones(24, np.uint8)  # would alias a flag without stuffing
        stuffed = bit_stuff(bits)
        s = "".join(map(str, stuffed))
        assert "111111" not in s

    def test_nrzi_roundtrip(self):
        rng = np.random.RandomState(1)
        bits = rng.randint(0, 2, 500).astype(np.uint8)
        np.testing.assert_array_equal(nrzi_decode(nrzi_encode(bits)), bits)

    def test_crc_x25_vector(self):
        # well-known check value: CRC-16/X-25 of b"123456789" = 0x906E
        data = np.frombuffer(b"123456789", np.uint8)
        assert crc16_x25(data) == 0x906E


class TestFrameCodec:
    def test_ui_frame_roundtrip(self):
        proto = loadProtocol("AX25")(conf=None)
        payload = np.arange(1, 60, dtype=np.uint8)
        frame = build_ui_frame(payload, dest="CQ", src="N0CALL")
        bits = np.r_[np.tile(FLAG, 3), bit_stuff(bytes_to_bits_lsb(frame)),
                     np.tile(FLAG, 2)]
        pkt = proto.Packet(np.r_[bits, np.zeros(8, np.uint8)])
        data, err, _ = pkt.getBinaryData()
        assert err == 0
        np.testing.assert_array_equal(data, payload)
        assert pkt.getAsciiAddress() == "N0CALL>CQ"

    def test_fcs_detects_corruption(self):
        proto = loadProtocol("AX25")(conf=None)
        payload = np.arange(1, 30, dtype=np.uint8)
        frame = build_ui_frame(payload)
        raw = bytes_to_bits_lsb(frame)
        raw[40] ^= 1  # corrupt a payload bit (before stuffing)
        bits = np.r_[np.tile(FLAG, 3), bit_stuff(raw), np.tile(FLAG, 2)]
        _, err, _ = proto.Packet(bits).getBinaryData()
        assert err == -1


class TestFrameFinderFlags:
    def test_finds_ax25_frame_in_stream(self):
        from pycusdr_tpu.decode import Decoder

        proto = loadProtocol("AX25")(conf=None)
        dec = Decoder({}, proto)

        payload = np.arange(1, 50, dtype=np.uint8)
        frame = build_ui_frame(payload)
        onair = np.r_[np.tile(FLAG, 6), bit_stuff(bytes_to_bits_lsb(frame)),
                      np.tile(FLAG, 2)].astype(np.uint8)
        rng = np.random.RandomState(3)
        filler = rng.randint(0, 2, 600).astype(np.uint8)
        filler[::6] = 0  # no fake flags in the noise
        stream = nrzi_encode(np.r_[filler, onair, filler])

        pkts, _, _ = dec.findFrames(stream, 0)
        assert pkts, "no AX.25 frame found"
        results = [p.getBinaryData() for p in pkts]
        good = [d for d, e, _ in results if e == 0 and len(d) == len(payload)]
        assert good, f"no CRC-clean frame: {[(e, len(d)) for d, e, _ in results]}"
        np.testing.assert_array_equal(good[0], payload)


def test_ax25_full_modem_loop(bench_conf):
    """Tx framer + GMSK LUT -> channel -> streamed Rx -> AX.25 decode."""
    from test_e2e_modem import run_modem_stream
    from pycusdr_tpu.tx.modulator import Modulator

    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["Main"] = dict(conf["Main"], protocols={"UHF": "AX25"})
    conf["Radios"] = dict(conf["Radios"])
    conf["Radios"]["Tx"] = {
        "UHF": {"baud": 9600, "samplesPerSym": 16, "frequency_Hz": 437.3e6,
                "frequencyOffset_Hz": 38400, "Protocol": "UHF"}
    }

    proto = loadProtocol("AX25")(conf=conf)
    mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], proto)
    payload = np.frombuffer(b"HELLO VIA AX25 FROM THE JAX MODEM " * 3, np.uint8)
    wave = mod.encodeAndModulate(payload)

    from pycusdr_tpu.dsp.signal_gen import awgn
    rng = np.random.RandomState(4)
    sig = awgn(wave.astype(np.complex64), 22.0, rng=rng).astype(np.complex64)

    packets, _ = run_modem_stream(conf, "AX25", sig)
    assert packets, "no AX.25 packet through the modem"
    results = [p.getBinaryData() for p in packets]
    good = [d for d, e, _ in results if e == 0]
    assert good, "no CRC-clean AX.25 packet"
    np.testing.assert_array_equal(good[0], payload)


def test_ax25_gmsk_variant_full_loop(bench_conf):
    """G3RUH-style AX.25: GMSK air interface paired with a GMSK Rx bank."""
    from test_e2e_modem import run_modem_stream
    from pycusdr_tpu.tx.modulator import Modulator
    from pycusdr_tpu.dsp.signal_gen import awgn

    conf = {k: (dict(v) if isinstance(v, dict) else v) for k, v in bench_conf.items()}
    conf["Main"] = dict(conf["Main"], protocols={"UHF": "AX25"})
    conf["Radios"] = dict(conf["Radios"])
    # short preamble so the whole frame fits inside one demod block
    # (GMSK currently degrades near block seams -- known limitation;
    # the FSK variant test above exercises multi-block frames)
    conf["Radios"]["Protocol"] = {"ax25_modulation": "GMSK",
                                  "tx_num_preambles": 4}
    conf["Radios"]["Tx"] = {
        "UHF": {"baud": 9600, "samplesPerSym": 16, "frequency_Hz": 437.3e6,
                "frequencyOffset_Hz": 38400, "Protocol": "UHF"}
    }

    from pycusdr_tpu.protocol import loadProtocol
    proto = loadProtocol("AX25")(conf=conf)
    assert proto.modulation == "GMSK"
    mod = Modulator(conf, conf["Radios"]["Tx"]["UHF"], proto)
    payload = np.frombuffer(b"G3RUH AX25 OVER GMSK ON JAX ", np.uint8)
    wave = mod.encodeAndModulate(payload)
    rng = np.random.RandomState(6)
    sig = awgn(wave.astype(np.complex64), 22.0, rng=rng).astype(np.complex64)

    packets, _ = run_modem_stream(conf, "AX25", sig)
    good = [p.getBinaryData()[0] for p in packets if p.getBinaryData()[1] == 0]
    assert good, "no CRC-clean G3RUH AX.25 packet"
    np.testing.assert_array_equal(good[0], payload)


class TestG3RUHScrambler:
    def test_roundtrip(self):
        from pycusdr_tpu.protocol.ax25 import descramble_g3ruh, scramble_g3ruh

        rng = np.random.RandomState(2)
        bits = rng.randint(0, 2, 500).astype(np.uint8)
        d, _ = descramble_g3ruh(scramble_g3ruh(bits))
        # descrambler self-synchronizes after 17 bits
        np.testing.assert_array_equal(d[17:], bits[17:])

    def test_streaming_seam_context(self):
        """Block-split descrambling with carried 17-bit history must be
        identical to one-shot descrambling."""
        from pycusdr_tpu.protocol.ax25 import descramble_g3ruh, scramble_g3ruh

        rng = np.random.RandomState(3)
        bits = rng.randint(0, 2, 400).astype(np.uint8)
        tx = scramble_g3ruh(bits)
        whole, _ = descramble_g3ruh(tx)
        hist = None
        parts = []
        for chunk in np.array_split(tx, 7):
            d, hist = descramble_g3ruh(chunk, hist)
            parts.append(d)
        np.testing.assert_array_equal(np.concatenate(parts), whole)

    def test_self_synchronizing_after_error(self):
        from pycusdr_tpu.protocol.ax25 import descramble_g3ruh, scramble_g3ruh

        rng = np.random.RandomState(4)
        bits = rng.randint(0, 2, 300).astype(np.uint8)
        tx = scramble_g3ruh(bits)
        tx[100] ^= 1  # one channel bit error
        d, _ = descramble_g3ruh(tx)
        clean, _ = descramble_g3ruh(scramble_g3ruh(bits))
        # an error affects exactly the taps at +0, +12, +17
        diff = np.where(d != clean)[0]
        assert set(diff.tolist()) == {100, 112, 117}
        np.testing.assert_array_equal(d[118:], bits[118:])

    def test_gmsk_mode_scrambles_tx(self):
        """The GMSK AX.25 Tx stream must be G3RUH-scrambled (interop
        with real 9600-baud modems), and the Rx preprocessor must undo
        it across block seams."""
        from pycusdr_tpu.protocol import loadProtocol
        from pycusdr_tpu.protocol.ax25 import FLAG, nrzi_encode
        from pycusdr_tpu.tx.encoders import AX25Encoder

        conf = {"Radios": {"Protocol": {"ax25_modulation": "GMSK"}}}
        proto = loadProtocol("AX25")(conf=conf)
        assert proto.scramble
        enc = AX25Encoder(proto, {})
        onair = enc.encodeAndFrame(np.frombuffer(b"HELLO G3RUH", np.uint8))
        # scrambled: the plain NRZI flag run must NOT appear verbatim
        plain_flags = nrzi_encode(np.tile(FLAG, 4))
        as_str = "".join(map(str, onair[: 16 * 8]))
        assert "".join(map(str, plain_flags)) not in as_str

        # streamed preprocessor (as the frame finder drives it)
        state = {}
        parts = []
        for chunk in np.array_split(onair, 5):
            parts.append(proto.decoderPreprocessor(chunk, stream_state=state))
        rx = np.concatenate(parts)
        # after descramble+NRZI-decode the flags are back
        s = "".join(map(str, rx.astype(int)))
        assert "".join(map(str, np.tile(FLAG, 4))) in s
