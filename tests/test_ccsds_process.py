"""Concatenated CCSDS (conv K=7 r=1/2 + RS) through the REAL process
pipeline: orchestrator-spawned modulator/demodulator/decoder linked by
ZMQ. Exercises the demod-trust -> decoder_process -> soft-decision
streaming Viterbi plumbing end-to-end (library-level loops cover the
algorithm; this covers the wiring)."""

import os
import time

import numpy as np
import pytest
import zmq

from pycusdr_tpu.config.loader import load_modular_json

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "pycusdr_tpu", "config", "configs")


def test_concatenated_ccsds_through_processes():
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.dsp.signal_gen import awgn
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="ccsds", protocols={"UHF": "ccsds_conv"})
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    conf["Radios"]["Rx"]["UHF-H"]["Interfaces"] = {
        "RxInPort": "tcp://127.0.0.1:29660",
        "demodOut": "tcp://localhost:29603",
    }
    conf["Radios"]["Tx"] = {
        "UHF": {
            "baud": 9600, "samplesPerSym": 16,
            "frequency_Hz": 437.3e6, "frequencyOffset_Hz": 38400,
            "Protocol": "UHF",
            "Interfaces": {
                "TxModToUSRPPort": "tcp://127.0.0.1:29671",
                "TxDataIn": "tcp://127.0.0.1:29601",
            },
        }
    }
    conf["Demodulator"] = {"timeoutSeconds": 60}
    conf["Interfaces"]["Internal"].update({
        "demodIn": "tcp://*:29603", "demodOut": "tcp://localhost:29603",
        "decodeOut": "tcp://localhost:29604", "decodeIn": "tcp://*:29604",
    })
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": "tcp://*:29612"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = "127.0.0.1:29951"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=29902)

    ctx = zmq.Context()
    tx_in = ctx.socket(zmq.PUSH)
    tx_in.connect("tcp://127.0.0.1:29601")
    wave_out = ctx.socket(zmq.PULL)
    wave_out.connect("tcp://127.0.0.1:29671")
    wave_out.setsockopt(zmq.RCVTIMEO, 5000)
    rx_in = ctx.socket(zmq.PUB)
    rx_in.bind("tcp://127.0.0.1:29660")
    sink = ctx.socket(zmq.PULL)
    sink.connect("tcp://localhost:29612")
    sink.setsockopt(zmq.RCVTIMEO, 1500)

    sdr = PyCuSDR(dict(conf), args=None)
    sdr.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all(t.is_alive() for t in sdr.tasks):
            time.sleep(0.2)
        # the demod child compiles before it subscribes to the feed; a
        # loaded host can take longer than the fixed settle below
        for d in sdr.demodulators:
            d.warmedFlag.wait(120)
        time.sleep(4.0)

        payload = np.frombuffer(b"PROCESS-LEVEL CONCATENATED FRAME " * 7, np.uint8)[:223]

        rng = np.random.RandomState(0)
        step = 2**13 - 2**10
        decoded = None
        for attempt in range(10):
            tx_in.send(payload.tobytes())
            try:
                wave = np.frombuffer(wave_out.recv(), np.complex64)
            except zmq.error.Again:
                continue

            chan = awgn(wave, 12.0, rng=rng).astype(np.complex64)
            chan = np.r_[chan, np.zeros(6 * step, np.complex64)]
            for pos in range(0, len(chan), step // 2):
                rx_in.send(chan[pos : pos + step // 2].tobytes())
                time.sleep(0.01)
            try:
                decoded = sink.recv()
                break
            except zmq.error.Again:
                continue

        assert decoded is not None, "no decoded CCSDS frame from the pipeline"
        got = np.frombuffer(decoded, np.uint8)
        np.testing.assert_array_equal(got[: len(payload)], payload)
        assert not np.any(got[len(payload):]), "virtual fill not zero"
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass
        for s in (tx_in, wave_out, rx_in, sink):
            s.close()
        ctx.term()


def test_two_channel_ccsds_conv_vote_to_decoder():
    """2-channel vote group -> CCSDS-conv decoder (ADVICE r1 high
    finding): do_vote2's combined trust must reach the soft-decision
    Viterbi preprocessor in the positive-is-confident convention. Under
    the reference's negated 2-way wire convention every agreeing bit
    would arrive with trust -1, the preprocessor would erase the whole
    frame, and this test deadlocks with zero decoded packets."""
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.combine import SoftCombiner
    from pycusdr_tpu.protocol import loadProtocol
    from pycusdr_tpu.runtime.decoder_process import Decoder
    from pycusdr_tpu.tx.encoders import CCSDSConvEncoder

    proto = loadProtocol("ccsds_conv")(conf=None)
    enc = CCSDSConvEncoder(proto, {})
    payload = np.frombuffer(b"TWO-CHANNEL VOTED CCSDS FRAME " * 8, np.uint8)[:223]
    onair = enc.encodeAndFrame(payload).astype(np.int8)

    rng = np.random.RandomState(11)
    streams = {}
    for i, wid in enumerate(("gsA", "gsB")):
        delay = rng.randint(400, 900)
        b = np.r_[rng.randint(0, 2, delay), onair,
                  rng.randint(0, 2, 400)].astype(np.int8)
        flip = rng.rand(len(b)) < 0.002
        b[flip] ^= 1
        streams[wid] = b

    conf = load_modular_json(
        os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["SoftCombiner"] = dict(conf["SoftCombiner"], processingInterval=0.15)
    conf["Interfaces"] = {
        "Internal": {
            "demodIn": "tcp://*:23103",
            "demodOut": "tcp://localhost:23103",
            "decodeOut": "tcp://localhost:23104",
            "decodeIn": "tcp://*:23104",
        },
        "External": {"decodeBytesOut_ZMQ": {"ccsds_conv": "tcp://*:23112"}},
    }
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=23902)

    def wdict(workerId, bits, count):
        return {
            "workerId": workerId, "count": count, "timestamp": time.time(),
            "voteGroup": 0, "doppler": 0.0, "doppler_std": 0.0,
            "spSymEst": 16.0, "SNR": 10.0, "baudRate": 9600,
            "protocol": "ccsds_conv",
            "data": np.asarray(bits, np.int8),
            "trust": np.full(len(bits), 2, np.int8),
        }

    ctx = zmq.Context()
    out = ctx.socket(zmq.PUSH)
    out.connect(conf["Interfaces"]["Internal"]["demodOut"])
    sink = ctx.socket(zmq.PULL)
    sink.connect("tcp://localhost:23112")
    sink.setsockopt(zmq.RCVTIMEO, 2000)

    comb = SoftCombiner(conf)
    dec = Decoder(conf, {"ccsds_conv": proto})
    comb.start()
    dec.start()
    try:
        assert comb.ready.wait(20), "combiner did not come up"
        time.sleep(1.0)
        # pace blocks at the reference suite's cadence: the combiner
        # prunes unconsumed worker data after workerDataTimeout (3.5 s),
        # so a send gap longer than that drops bits mid-frame
        n_blocks = 6
        blocks = {k: np.array_split(v, n_blocks) for k, v in streams.items()}
        for i in range(n_blocks):
            for wid, chunks in blocks.items():
                out.send_pyobj(wdict(wid, chunks[i], i))
            time.sleep(0.2)
        decoded = None
        deadline = time.time() + 30
        while time.time() < deadline and decoded is None:
            try:
                decoded = sink.recv()
            except zmq.error.Again:
                pass
        assert decoded is not None, "no decoded frame from the 2-channel vote group"
        got = np.frombuffer(decoded, np.uint8)
        np.testing.assert_array_equal(got[: len(payload)], payload)
    finally:
        for p in (comb, dec):
            try:
                p.stop()
            except Exception:
                pass
        for p in (comb, dec):
            p.join(timeout=8)
            if p.is_alive():
                p.terminate()
        for s in (out, sink):
            s.close()
        ctx.term()


def test_vote2_trust_feeds_soft_viterbi_directly():
    """Unit-level pin of the ADVICE r1 high finding, no processes: a
    2-way voted stream's (bits, trust) must decode through the
    CCSDS-conv soft-decision preprocessor. Under the reference's
    negated convention every agreeing bit carries trust -1 and is
    erased, so zero frames survive — this asserts the normalized
    positive-good convention end to end."""
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.combine.votes import do_vote2
    from pycusdr_tpu.decode import Decoder as FrameFinder
    from pycusdr_tpu.protocol import loadProtocol
    from pycusdr_tpu.tx.encoders import CCSDSConvEncoder

    proto = loadProtocol("ccsds_conv")(conf=None)
    enc = CCSDSConvEncoder(proto, {})
    payload = np.arange(223, dtype=np.uint8)
    onair = enc.encodeAndFrame(payload).astype(np.int8)

    rng = np.random.RandomState(3)
    stream = np.r_[rng.randint(0, 2, 500), onair,
                   rng.randint(0, 2, 500)].astype(np.int8)
    chanA, chanB = stream.copy(), stream.copy()
    chanA[rng.rand(len(stream)) < 0.003] ^= 1
    chanB[rng.rand(len(stream)) < 0.003] ^= 1
    trust = np.full(len(stream), 2, np.int8)

    bitsV, trustV = do_vote2(chanA, trust, chanB, trust)
    # the voted trust must be usable as-is by the soft Viterbi: the
    # overwhelming majority of bits (agreements) must NOT be erasures
    assert (np.asarray(trustV) >= 0).mean() > 0.99

    dec = FrameFinder({}, proto)
    pkts, _, _ = dec.findFrames(np.asarray(bitsV), 0, trust=np.asarray(trustV))
    results = [p.getBinaryData() for p in pkts]
    good = [n for d, n, _ in results if n >= 0 and np.array_equal(d, payload)]
    assert good, f"voted stream did not decode: {[n for _, n, _ in results]}"
