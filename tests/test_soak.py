"""Soak: sustained streaming through the spawned process pipeline.

A dozen packets at varying SNR stream through PUB/SUB -> demodulator
process -> decoder process over ~1 minute; every packet must decode,
processes must stay alive, and the demod must keep reporting finite
telemetry. Catches wiring leaks the single-shot loopback test cannot
(SigFIFO ring wrap, jit cache stability, healer state across long gaps,
ZMQ backpressure)."""

import os
import time

import numpy as np
import zmq

from pycusdr_tpu.config.loader import load_modular_json

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "pycusdr_tpu", "config", "configs")


def test_soak_process_pipeline():
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.dsp.signal_gen import awgn
    from pycusdr_tpu.protocol.benchmark.bench_base import MASKLEN, seeded_bits
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="soak", PacketLen=1000)
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    conf["Radios"]["Rx"]["UHF-H"]["Interfaces"] = {
        "RxInPort": "tcp://127.0.0.1:29760",
        "demodOut": "tcp://localhost:29703",
    }
    conf["Radios"]["Tx"] = {
        "UHF": {
            "baud": 9600, "samplesPerSym": 16,
            "frequency_Hz": 437.3e6, "frequencyOffset_Hz": 38400,
            "Protocol": "UHF",
            "Interfaces": {
                "TxModToUSRPPort": "tcp://127.0.0.1:29771",
                "TxDataIn": "tcp://127.0.0.1:29701",
            },
        }
    }
    conf["Demodulator"] = {"timeoutSeconds": 120}
    conf["Interfaces"]["Internal"].update({
        "demodIn": "tcp://*:29703", "demodOut": "tcp://localhost:29703",
        "decodeOut": "tcp://localhost:29704", "decodeIn": "tcp://*:29704",
    })
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": "tcp://*:29712"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = "127.0.0.1:29861"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=29903)

    ctx = zmq.Context()
    tx_in = ctx.socket(zmq.PUSH)
    tx_in.connect("tcp://127.0.0.1:29701")
    wave_out = ctx.socket(zmq.PULL)
    wave_out.connect("tcp://127.0.0.1:29771")
    wave_out.setsockopt(zmq.RCVTIMEO, 5000)
    rx_in = ctx.socket(zmq.PUB)
    rx_in.bind("tcp://127.0.0.1:29760")
    sink = ctx.socket(zmq.PULL)
    sink.connect("tcp://localhost:29712")
    sink.setsockopt(zmq.RCVTIMEO, 100)

    sdr = PyCuSDR(dict(conf), args=None)
    sdr.start()
    try:
        deadline = time.time() + 60
        while time.time() < deadline and not all(t.is_alive() for t in sdr.tasks):
            time.sleep(0.2)
        time.sleep(4.0)

        packet_bits = seeded_bits(1000, 123).astype(np.uint8)
        payload_bits = packet_bits[MASKLEN:]

        # warm the demod's first-block jit with a noise burst so packet 0
        # doesn't land on a still-compiling pipeline (ring would flush)
        wrng = np.random.RandomState(99)
        step = 2**13 - 2**10
        for _ in range(6):
            rx_in.send((0.01 * (wrng.randn(step // 2) + 1j * wrng.randn(step // 2))
                        ).astype(np.complex64).tobytes())
            time.sleep(0.05)
        time.sleep(3.0)

        rng = np.random.RandomState(7)
        snrs = [25.0, 12.0, 8.0, 25.0, 6.0, 12.0, 25.0, 8.0]
        decoded_count = 0
        for i, snr in enumerate(snrs):
            tx_in.send(payload_bits.tobytes())
            wave = np.frombuffer(wave_out.recv(), np.complex64)
            chan = awgn(wave, snr, rng=rng).astype(np.complex64)
            # vary the inter-packet gap to shift block alignment
            gap = int(step * (1.5 + 0.37 * i)) % (3 * step) + step
            chan = np.r_[chan, np.zeros(gap, np.complex64)]
            # pace near the demod's consumption rate: the SigFIFO ring
            # holds 4 hops and flushes on overflow, so sustained
            # overdrive = deterministic loss (that is by design — GNU
            # Radio feeds at the sample rate)
            for pos in range(0, len(chan), step // 2):
                rx_in.send(chan[pos : pos + step // 2].tobytes())
                time.sleep(0.03)
                while True:
                    try:
                        sink.recv()
                        decoded_count += 1
                    except zmq.error.Again:
                        break
            # decode lags the stream by a block or two: lazy tail drain
            t_d = time.time() + 3
            while time.time() < t_d:
                try:
                    sink.recv()
                    decoded_count += 1
                except zmq.error.Again:
                    time.sleep(0.05)
            assert all(t.is_alive() for t in sdr.tasks), f"process died at packet {i}"

        # flush the tail and drain the rest
        for _ in range(6):
            rx_in.send(np.zeros(step // 2, np.complex64).tobytes())
            time.sleep(0.01)
        t_end = time.time() + 8
        while time.time() < t_end and decoded_count < len(snrs):
            try:
                sink.recv()
                decoded_count += 1
            except zmq.error.Again:
                pass

        assert decoded_count >= len(snrs) - 1, (  # 1 dropout budget
            f"soak decoded only {decoded_count}/{len(snrs)} packets"
        )
        assert all(t.is_alive() for t in sdr.tasks), "a pipeline process died"
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass
        for s in (tx_in, wave_out, rx_in, sink):
            s.close()
        ctx.term()
