"""Batched streaming (processMany): one vmapped dispatch over K hops
must produce exactly the same bit stream as the per-block API."""

import numpy as np

from pycusdr_tpu.models import UHF
from pycusdr_tpu.protocol import loadProtocol

from conftest import make_fsk_signal


def test_process_many_matches_sequential(bench_conf):
    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    dA = UHF.Demodulator(bench_conf, protocol, "UHF-H")
    dB = UHF.Demodulator(bench_conf, protocol, "UHF-H")

    N, ov = dA.Nfft, dA.sigOverlap
    hop = N - ov
    K = 6
    rng = np.random.RandomState(3)
    nbits = (ov + hop * K) // 16 + 8
    bits = rng.randint(0, 2, nbits)
    sig = make_fsk_signal(bits, 16, 38400 / dA.spec.sampleRate, seed=4, noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K, np.complex64)][: hop * K]
    hops = sig.reshape(K, hop)

    # A: per-block streaming
    rawA = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(K):
        rawA[ov:] = hops[i]
        dA.uploadAndFindCarrier(rawA)
        b, _, t, _ = dA.demodulate()
        seqA.append((b, t))
        rawA[:ov] = rawA[-ov:]

    # B: batched (3 + 3)
    seqB = []
    for chunk in (hops[:3], hops[3:]):
        for res in dB.processMany(chunk):
            seqB.append((res["bits"], res["trust"]))

    assert len(seqA) == len(seqB) == K
    for i, ((ba, ta), (bb, tb)) in enumerate(zip(seqA, seqB)):
        np.testing.assert_array_equal(ba, bb, err_msg=f"bits differ at block {i}")
        np.testing.assert_array_equal(ta, tb, err_msg=f"trust differs at block {i}")


def test_process_many_chunk_evaluated_matches_per_block(bench_conf):
    """K=32 crosses BATCH_CHUNK, so processMany evaluates two 16-wide
    sub-batches inside one jit (dsp.block.build_process_batch) — the
    production backlog dispatch shape (maxBatchBlocks 16). Bits/trust
    must match the per-block stream exactly."""
    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    dA = UHF.Demodulator(bench_conf, protocol, "UHF-H")
    dB = UHF.Demodulator(bench_conf, protocol, "UHF-H")

    N, ov = dA.Nfft, dA.sigOverlap
    hop = N - ov
    K = 32
    rng = np.random.RandomState(9)
    nbits = (ov + hop * K) // 16 + 8
    bits = rng.randint(0, 2, nbits)
    sig = make_fsk_signal(bits, 16, 38400 / dA.spec.sampleRate, seed=10,
                          noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K, np.complex64)][: hop * K]
    hops = sig.reshape(K, hop)

    rawA = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(K):
        rawA[ov:] = hops[i]
        dA.uploadAndFindCarrier(rawA)
        b, _, t, _ = dA.demodulate()
        seqA.append((b, t))
        rawA[:ov] = rawA[-ov:]

    seqB = [(res["bits"], res["trust"]) for res in dB.processMany(hops)]
    assert len(seqA) == len(seqB) == K
    for i, ((ba, ta), (bb, tb)) in enumerate(zip(seqA, seqB)):
        np.testing.assert_array_equal(ba, bb, err_msg=f"bits differ at block {i}")
        np.testing.assert_array_equal(ta, tb, err_msg=f"trust differs at block {i}")


def test_sigfifo_getblocks_drains_backlog():
    import threading
    import time

    import zmq

    from pycusdr_tpu.runtime.sigfifo import SigFIFO

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:32560")
    fifo = SigFIFO("tcp://127.0.0.1:32560", 1000, timeoutRetries=50)
    time.sleep(0.5)

    data = np.arange(3500).astype(np.complex64)
    for pos in range(0, 3500, 700):
        pub.send(data[pos : pos + 700].tobytes())
    time.sleep(0.3)

    blocks = fifo.getBlocks(4)
    assert len(blocks) == 3  # 3500 samples -> 3 full hops buffered
    got = np.concatenate(blocks)
    np.testing.assert_array_equal(got, data[:3000])
    pub.close()
    ctx.term()


def test_scan_stream_matches_sequential(bench_conf):
    """The on-device lax.scan capture processor equals per-block calls."""
    import jax

    from pycusdr_tpu.dsp.block import build_process_block, build_process_stream
    from pycusdr_tpu.dsp.spec import build_spec
    from pycusdr_tpu.ops.cfft import c2ri

    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    spec = build_spec(bench_conf, protocol, "UHF-H")
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    K = 5
    rng = np.random.RandomState(8)
    bits = rng.randint(0, 2, (ov + hop * K) // 16 + 8)
    sig = make_fsk_signal(bits, 16, 38400 / spec.sampleRate, seed=5, noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K + ov, np.complex64)]

    stream = build_process_stream(spec)
    carry = c2ri(sig[:ov])
    hops = np.stack([c2ri(sig[ov + i * hop : ov + (i + 1) * hop]) for i in range(K)])
    res, carry_out = stream(hops, carry)

    single = build_process_block(spec, jit=True)
    for i in range(K):
        block = sig[i * hop : i * hop + N]
        ref = {k: np.asarray(v) for k, v in single(c2ri(block)).items()}
        n = int(ref["nBits"])
        np.testing.assert_array_equal(np.asarray(res["bits"])[i, :n], ref["bits"][:n],
                                      err_msg=f"scan block {i}")
    np.testing.assert_allclose(np.asarray(carry_out), c2ri(sig[hop * K : hop * K + ov]),
                               rtol=1e-6)


def test_pipelined_dispatch_matches_sequential(bench_conf):
    """Depth-2 pipelined streaming (dispatch k+1 before collecting k)
    must produce exactly the synchronous per-block bit stream, one
    block later."""
    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    dA = UHF.Demodulator(bench_conf, protocol, "UHF-H")
    dB = UHF.Demodulator(bench_conf, protocol, "UHF-H")

    N, ov = dA.Nfft, dA.sigOverlap
    hop = N - ov
    K = 6
    rng = np.random.RandomState(7)
    nbits = (ov + hop * K) // 16 + 8
    bits = rng.randint(0, 2, nbits)
    sig = make_fsk_signal(bits, 16, 38400 / dA.spec.sampleRate, seed=8, noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K, np.complex64)][: hop * K]
    hops = sig.reshape(K, hop)

    # A: synchronous per-block streaming
    rawA = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(K):
        rawA[ov:] = hops[i]
        seqA.append(dA.process(rawA))
        rawA[:ov] = rawA[-ov:]

    # B: depth-2 pipeline — one handle always in flight; the staging
    # buffer advances BEFORE the previous block is collected (the
    # dispatch must have snapshotted its input)
    rawB = dB.get_signalBufferHostPointer()
    seqB = []
    inflight = []
    for i in range(K):
        rawB[ov:] = hops[i]
        inflight.append(dB.dispatch(rawB))
        rawB[:ov] = rawB[-ov:]
        if len(inflight) >= 2:
            seqB.append(dB.collect(inflight.pop(0)))
    while inflight:
        seqB.append(dB.collect(inflight.pop(0)))

    assert len(seqA) == len(seqB) == K
    for i, (a, b) in enumerate(zip(seqA, seqB)):
        np.testing.assert_array_equal(a["bits"], b["bits"],
                                      err_msg=f"bits differ at block {i}")
        np.testing.assert_array_equal(a["trust"], b["trust"],
                                      err_msg=f"trust differs at block {i}")
        assert a["doppler"] == b["doppler"]
        assert a["SNR"] == b["SNR"]


def test_pipelined_inflight_flushes_when_feed_pauses():
    """With pipelineDepth=3 and only 2 hops fed, the depth alone would
    hold both blocks in flight; the idle-feed drain (and, as a safety
    net, the feed-timeout flush) must still ship both computed blocks
    in order instead of holding them for the timeout window."""
    import os
    import time

    import zmq

    from pycusdr_tpu.config.loader import load_modular_json
    from pycusdr_tpu.runtime.demodulator_process import Demodulator_process

    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    conf_dir = os.path.join(os.path.dirname(__file__), "..",
                            "pycusdr_tpu", "config", "configs")
    conf = load_modular_json(os.path.join(conf_dir, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="flush", PacketLen=1000)
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["GPU"]["UHF"].setdefault("TPU", {})["pipelineDepth"] = 3
    conf["GPU"]["UHF"]["TPU"]["maxBatchBlocks"] = 1  # force per-block path
    conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    conf["Radios"]["Rx"]["UHF-H"]["Interfaces"] = {
        "RxInPort": "tcp://127.0.0.1:37560",
        "demodOut": "tcp://localhost:37003",
    }
    conf["Demodulator"] = {"timeoutSeconds": 2}

    protocol = loadProtocol("bench_FSK")(conf=conf)

    ctx = zmq.Context()
    sink = ctx.socket(zmq.PULL)
    sink.bind("tcp://*:37003")
    sink.setsockopt(zmq.RCVTIMEO, 1000)
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:37560")

    proc = Demodulator_process(conf, protocol, "UHF-H")
    proc.start()
    try:
        time.sleep(6.0)  # spawn + jit warm-up (slow-joiner PUB is fine: keep sending)
        hop = 2**13 - 2**10
        rng = np.random.RandomState(0)
        sig = (rng.randn(2 * hop) + 1j * rng.randn(2 * hop)).astype(np.complex64)
        deadline = time.time() + 30
        got = []
        sent = 0
        while time.time() < deadline and len(got) < 2:
            # keep re-feeding 2-hop bursts until the child's SUB is up
            # and a feed-timeout cycle has flushed them
            if sent == 0:
                for pos in range(0, len(sig), hop // 2):
                    pub.send(sig[pos: pos + hop // 2].tobytes())
                sent = 1
            try:
                got.append(sink.recv_pyobj())
                continue
            except zmq.error.Again:
                pass
            if proc.GRCTimeout():
                sent = 0  # timed out: next loop feeds another burst
        assert len(got) >= 2, "in-flight blocks were not flushed on feed timeout"
        counts = [d["count"] for d in got[:2]]
        assert counts == sorted(counts), f"flush out of order: {counts}"
        assert all(np.isfinite(d["SNR"]) for d in got[:2])
    finally:
        proc.stop()
        proc.join(timeout=10)
        if proc.is_alive():
            proc.terminate()
        pub.close()
        sink.close()
        ctx.term()


def test_capture_processor_matches_scan(bench_conf):
    """The strided-framing capture processor (batched, the offline
    reprocessing route) must be BIT-IDENTICAL to the lax.scan stream
    route, including the carry (VERDICT r3 #3)."""
    from pycusdr_tpu.dsp.block import build_process_capture, build_process_stream
    from pycusdr_tpu.dsp.spec import build_spec
    from pycusdr_tpu.ops.cfft import c2ri

    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    spec = build_spec(bench_conf, protocol, "UHF-H")
    N, ov = spec.Nfft, spec.sigOverlap
    hop = N - ov
    for K in (5, 6):  # 6 = 2 x chunk at chunk=3 exercises chunking
        rng = np.random.RandomState(8 + K)
        bits = rng.randint(0, 2, (ov + hop * K) // 16 + 8)
        sig = make_fsk_signal(bits, 16, 38400 / spec.sampleRate, seed=5,
                              noise_std=0.05)
        sig = np.r_[sig, np.zeros(hop * K + ov, np.complex64)]

        carry = c2ri(sig[:ov])
        hops = np.stack([c2ri(sig[ov + i * hop : ov + (i + 1) * hop])
                         for i in range(K)])

        res_a, carry_a = build_process_stream(spec)(hops, carry)
        res_b, carry_b = build_process_capture(spec, chunk=3)(hops, carry)
        assert set(res_a) == set(res_b)
        for k in res_a:
            a, b = np.asarray(res_a[k]), np.asarray(res_b[k])
            if a.dtype.kind in "iub" or k in ("bits", "trust", "symbols",
                                              "centres", "mags"):
                # every DECISION output is bit-identical
                np.testing.assert_array_equal(
                    a, b, err_msg=f"capture output {k!r} != scan (K={K})")
            else:
                # analog scalars (codeOffset, code_val, ...) may differ
                # by last-ulp accumulation order: the vmapped batch
                # tiles its matmuls differently than the scanned graph
                np.testing.assert_allclose(
                    a, b, rtol=1e-5, atol=1e-5,
                    err_msg=f"capture output {k!r} drifted (K={K})")
        np.testing.assert_array_equal(np.asarray(carry_a), np.asarray(carry_b))


def test_process_capture_matches_streaming(bench_conf):
    """Demodulator.processCapture (the public offline-reprocessing API)
    must produce the same healed bit stream as live per-block streaming
    of the same samples, and leave the overlap-save history so live
    streaming can resume."""
    protocol = loadProtocol("bench_FSK")(conf=bench_conf)
    dA = UHF.Demodulator(bench_conf, protocol, "UHF-H")
    dB = UHF.Demodulator(bench_conf, protocol, "UHF-H")

    N, ov = dA.Nfft, dA.sigOverlap
    hop = N - ov
    K = 7
    rng = np.random.RandomState(9)
    bits = rng.randint(0, 2, (hop * K) // 16 + 8)
    sig = make_fsk_signal(bits, 16, 38400 / dA.spec.sampleRate, seed=3,
                          noise_std=0.05)
    sig = np.r_[sig, np.zeros(hop * K, np.complex64)][: hop * K - hop // 3]

    # A: live per-block streaming (pad the tail hop with zeros, as the
    # capture API does internally)
    padded = np.zeros(hop * K, np.complex64)
    padded[: len(sig)] = sig
    rawA = dA.get_signalBufferHostPointer()
    seqA = []
    for i in range(K):
        rawA[ov:] = padded[i * hop : (i + 1) * hop]
        seqA.append(dA.process(rawA))
        rawA[:ov] = rawA[-ov:]

    # B: one capture call, chunked across multiple dispatches (the K=7
    # tail exercises the power-of-two decomposition: 4 + 2 + 1)
    seqB = dB.processCapture(sig, max_hops_per_dispatch=4)
    assert len(seqB) == K
    for i, (a, b) in enumerate(zip(seqA, seqB)):
        np.testing.assert_array_equal(a["bits"], b["bits"],
                                      err_msg=f"capture block {i} bits")
        np.testing.assert_array_equal(a["trust"], b["trust"],
                                      err_msg=f"capture block {i} trust")
    # overlap-save history left in place for a live resume
    np.testing.assert_allclose(
        dB.get_signalBufferHostPointer()[:ov],
        dA.get_signalBufferHostPointer()[:ov], rtol=1e-6, atol=1e-7)

    # NON-power-of-two dispatch cap (round-5 review regression: a
    # mid-capture zero-padded dispatch corrupted the device carry
    # chain): cap 3 floors to pow2 2, so mid-capture dispatches are
    # exact slices and the carry chain must stay bit-correct
    dC = UHF.Demodulator(bench_conf, protocol, "UHF-H")
    seqC = dC.processCapture(sig, max_hops_per_dispatch=3)
    assert len(seqC) == K
    for i, (a, c) in enumerate(zip(seqA, seqC)):
        np.testing.assert_array_equal(a["bits"], c["bits"],
                                      err_msg=f"capture block {i} bits (cap 3)")
    np.testing.assert_allclose(
        dC.get_signalBufferHostPointer()[:ov],
        dA.get_signalBufferHostPointer()[:ov], rtol=1e-6, atol=1e-7)


def test_batch16_rows_match_single_dispatch():
    """Row k of a B=16 build_process_batch dispatch equals a single
    dispatch of block k on every output the streaming runtime consumes
    (the analog estimates may differ in the last ulps between shapes)."""
    import __graft_entry__ as g
    from chip_smoke import DECISION_KEYS
    from pycusdr_tpu.dsp.block import (
        build_process_batch,
        build_process_block,
        unpack_block_outputs,
    )
    from pycusdr_tpu.ops.cfft import c2ri

    spec = g.tiny_spec()
    rng = np.random.RandomState(12)
    blocks = []
    for k in range(16):
        bits = rng.randint(0, 2, spec.Nfft // int(spec.spsym) + 1)
        off = (spec.centreFreqOffset + 300.0 * (k - 8)) / spec.sampleRate
        blocks.append(make_fsk_signal(bits, int(spec.spsym), off, seed=k,
                                      noise_std=0.1)[: spec.Nfft])
    x = c2ri(np.stack(blocks))
    single = build_process_block(spec, latency_mode=True, packed=True)
    rows = np.asarray(build_process_batch(spec, packed=True)(x))
    assert rows.shape[0] == 16
    for k in range(16):
        a = unpack_block_outputs(np.asarray(single(x[k])), spec)
        b = unpack_block_outputs(rows[k], spec)
        for q in DECISION_KEYS:
            np.testing.assert_array_equal(a[q], b[q], err_msg=f"row {k}: {q}")
