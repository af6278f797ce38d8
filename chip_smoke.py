#!/usr/bin/env python3
"""Smoke test of the modem's main path on an NVIDIA GPU.

Run from the repository root on a machine with the card:

    python chip_smoke.py               # phases (e), (a)-(d) on one card
    python chip_smoke.py --four-cards  # the multi-card phase only, 4 cards

Phases, each printing one line of its own (any failure raises and the
script exits non-zero; nothing is caught and passed over):

(e) process pipeline, when pyzmq is installed: the orchestrator runs one
    CC11xx Rx radio (demod child on the card, decoder child on the CPU)
    fed by bursts from ``examples/gnuradio/sim_frontend.py``; every
    packet on ``decodeBytesOut`` must be a seeded payload, and the card
    must hold exactly one process, the demod child. It runs FIRST so
    that this process has not yet opened the card.
(a) device: JAX's devices are GPUs; prints the card's name and power
    limit, the JAX version and the compile-cache directory.
(b) block graph vs the numpy reference (``dsp/reference.py``) on a
    seeded CC11xx burst at the flagship, STX and CC11xx.json shapes.
(c) dispatch-shape identity at the CC11xx.json shape: latency graph ==
    batch graph, packed == dict outputs, both decode the packet
    CRC-clean, and every row of a B=16 batch == a single dispatch.
(d) modem loop: seconds of CC11xx air (>= 8 packets with Doppler, AWGN)
    through ``UHF.Demodulator`` three ways (dispatch/collect,
    processMany, processCapture) and ``decode.Decoder``; every packet
    decodes CRC-clean and bit-exact, and the three bit streams match.

``--four-cards`` runs only the sharded programs at the flagship shape
(channel-only mesh, the channel x dopp tensor split at M=8 and M=32,
and the time-sharded halo stream) against the single-card graph.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
CC11XX_JSON = os.path.join(ROOT, "pycusdr_tpu", "config", "configs", "CC11xx.json")

#: outputs the streaming runtime consumes (healing, decode, steering);
#: these must be bit-identical across dispatch shapes. The analog
#: estimates (E, mags, snr_db, dopp_idx, codeOffset, ...) may differ in
#: the last ulps between a vmapped and a single dispatch on any backend.
DECISION_KEYS = ("bits", "trust", "symbols", "centres", "nSym", "nBits",
                 "shift", "spSym")

#: phase (b) tolerances, f32 graph vs the float64 numpy reference. The
#: graph's precision: complex64 FFTs (cuFFT), the Doppler contraction
#: and the one-hot selects at ``precision=HIGHEST`` (true f32, no TF32).
#: Doppler bin, samples-per-symbol estimate and bits/trust on the burst
#: must be equal; mags within 1e-3 of the burst's largest magnitude (f32
#: FFT rounding, and plateau ties where adjacent offsets are equal to
#: f32 precision); SNR within 0.05 dB (mean of |S| over ~1e3 bins in f32).
MAGS_RTOL = 1e-3
SNR_ATOL_DB = 0.05


class CheckFailed(AssertionError):
    pass


def check(ok, msg):
    if not ok:
        raise CheckFailed(msg)


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    """``nvidia-smi`` name and power limit of every card (raises when
    there is no NVIDIA driver)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return "; ".join(line.strip() for line in out.stdout.splitlines() if line.strip())


# ---------------------------------------------------------------- configs


def cc11xx_conf(small=False):
    """The CC11xx.json deployment; ``small`` cuts it to CPU-test size
    (9600 baud x 16 sps, Nfft 2^13, 16 Doppler bins)."""
    from pycusdr_tpu.config.loader import load_modular_json

    conf = load_modular_json(CC11XX_JSON)
    if small:
        conf["GPU"]["UHF"].update(blockSize=13, overlap=10, doppCarrierSteps=16)
        conf["Radios"]["rangeRateMax"] = 7500
        for r in (conf["Radios"]["Rx"]["UHF-H"], conf["Radios"]["Tx"]["UHF"]):
            r.update(baud=9600, samplesPerSym=16, frequencyOffset_Hz=38400)
        conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    return conf


def cc11xx_spec(conf):
    from pycusdr_tpu.dsp.spec import build_spec
    from pycusdr_tpu.protocol import loadProtocol

    return build_spec(conf, loadProtocol("CC11xx")(conf=conf), "UHF-H")


def modulator_for(spec, rx_fc):
    """A CC11xx Tx chain at ``spec``'s baud, samples per symbol and IF
    offset (its waveform lands where the spec's Rx expects it)."""
    from pycusdr_tpu.protocol import loadProtocol
    from pycusdr_tpu.tx.modulator import Modulator

    conf = cc11xx_conf()
    tx = conf["Radios"]["Tx"]["UHF"]
    tx.update(baud=float(spec.baudRate), samplesPerSym=int(round(spec.spsym)),
              frequency_Hz=rx_fc, frequencyOffset_Hz=float(spec.centreFreqOffset))
    return Modulator(conf, tx, loadProtocol("CC11xx")(conf=conf))


def burst(mod, payload, rangerate):
    """The modulated burst without the Tx chain's low-power padding."""
    mod.set_rangerate(rangerate)
    w = np.asarray(mod.encodeAndModulate(payload.tobytes()), np.complex64)
    on = np.nonzero(np.abs(w) > 1e-3)[0]
    return w[on[0]: on[-1] + 1]


def noise(rng, n, power):
    return (np.sqrt(power / 2) * (rng.randn(n) + 1j * rng.randn(n))).astype(np.complex64)


def burst_block(spec, mod, payload, rangerate, seed, snr_db=15.0):
    """One Nfft block: AWGN floor (power 1e-2) plus a CC11xx burst at
    ``snr_db`` per sample from Nfft/32 on (cut at the block's end).
    Returns (block, burst sample span)."""
    rng = np.random.RandomState(seed)
    start = spec.Nfft // 32
    wave = burst(mod, payload, rangerate)
    wave = wave[: spec.Nfft - start]
    block = noise(rng, spec.Nfft, 1e-2)
    block[start:start + len(wave)] += wave * np.float32(np.sqrt(1e-2 * 10 ** (snr_db / 10)))
    return block, (start, start + len(wave))


# ---------------------------------------------------------------- phase (b)


def check_block_vs_reference(spec, block, span):
    """The jitted block graph against ``demod_block_numpy`` on one
    block: Doppler bin, samples-per-symbol estimate and bits/trust on
    the burst equal; mags and SNR within the stated tolerances."""
    from pycusdr_tpu.dsp.block import build_process_block
    from pycusdr_tpu.dsp.reference import demod_block_numpy
    from pycusdr_tpu.ops.cfft import c2ri

    ref = demod_block_numpy(spec, block)
    out = {k: np.asarray(v) for k, v in build_process_block(spec)(c2ri(block)).items()}
    n = int(out["nBits"])
    check(n == len(ref["bits"]), f"nBits {n} vs reference {len(ref['bits'])}")
    check(int(out["shift"]) == int(ref["shift"]),
          f"Doppler bin {int(out['shift'])} vs reference {ref['shift']}")
    check(abs(float(out["spSym"]) - ref["spSym"]) <= 1e-6 * ref["spSym"],
          f"spSym {float(out['spSym'])} vs reference {ref['spSym']}")
    # symbol slots whose centre lies on the burst, one symbol in from
    # either edge
    sp = float(ref["spSym"])
    c = ref["centres"][:n]
    on = (c >= span[0] + sp) & (c < span[1] - sp)
    check(on.sum() > 16, f"only {on.sum()} symbol slots on the burst")
    check(np.array_equal(out["bits"][:n][on], ref["bits"][on]),
          f"{int(np.sum(out['bits'][:n][on] != ref['bits'][on]))} bits differ on the burst")
    check(np.array_equal(out["trust"][:n][on], ref["trust"][on]), "trust differs on the burst")
    mags_err = float(np.max(np.abs(out["mags"][:n][on] - ref["mags"][on]))
                     / np.max(ref["mags"][on]))
    check(mags_err <= MAGS_RTOL, f"mags rel error {mags_err:.3g} > {MAGS_RTOL}")
    snr_err = 0.0
    if spec.doppler_search:
        snr_err = abs(float(out["snr_db"]) - float(ref["snr_db"]))
        check(snr_err <= SNR_ATOL_DB, f"snr_db error {snr_err:.3g} dB > {SNR_ATOL_DB}")
    return {"shift": int(out["shift"]), "spSym": float(out["spSym"]),
            "burst_slots": int(on.sum()), "mags_rel_err": mags_err,
            "snr_err_db": snr_err}


def phase_b_specs(small=False):
    """(name, spec, Rx carrier, rangerate) for the three phase (b) shapes."""
    import __graft_entry__ as g

    if small:
        conf = cc11xx_conf(small=True)
        return [("tiny", g.tiny_spec(), 437.3e6, 1500.0),
                ("cc11xx-small", cc11xx_spec(conf), 401.538e6, 3000.0)]
    conf = cc11xx_conf()
    return [("flagship", g.flagship_spec(), 437.3e6, 2500.0),
            ("stx", g.stx_spec(), 437.3e6, 0.0),
            ("cc11xx", cc11xx_spec(conf),
             conf["Radios"]["Rx"]["UHF-H"]["frequency_Hz"], 9000.0)]


def phase_b():
    for name, spec, fc, rr in phase_b_specs():
        mod = modulator_for(spec, fc)
        n_bytes = max(4, min(200, (spec.Nfft // 3) // (8 * int(round(spec.spsym))) - 20))
        payload = np.random.RandomState(5).randint(0, 256, n_bytes).astype(np.uint8)
        block, span = burst_block(spec, mod, payload, rr if spec.doppler_search else 0.0, seed=11)
        r = check_block_vs_reference(spec, block, span)
        say("b", f"PASS block graph == reference at {name} (Nfft {spec.Nfft}, D {spec.D}, "
                 f"M {spec.num_masks}): {json.dumps(r)}")


# ---------------------------------------------------------------- phase (c)


def decode_blocks(conf, protocol, spec, graph, blocks, payload):
    """Feed ``blocks`` through ``graph`` (packed) and a fresh decoder;
    True when ``payload`` comes out CRC-clean."""
    from pycusdr_tpu.decode import Decoder
    from pycusdr_tpu.dsp.block import unpack_block_outputs

    dec = Decoder(conf.get("decoder", {}), protocol)
    for x in blocks:
        r = unpack_block_outputs(np.asarray(graph(x)), spec)
        pkts, _, _ = dec.findFrames(np.asarray(r["bits"])[: int(r["nBits"])], 0)
        for p in pkts:
            data, crcErr, _ = p.getBinaryData()
            if not crcErr and np.array_equal(np.asarray(data), payload):
                return True
    return False


def phase_c(conf):
    from pycusdr_tpu.dsp.block import (
        build_process_batch,
        build_process_block,
        unpack_block_outputs,
    )
    from pycusdr_tpu.ops.cfft import c2ri
    from pycusdr_tpu.protocol import loadProtocol

    protocol = loadProtocol("CC11xx")(conf=conf)
    spec = cc11xx_spec(conf)
    mod = modulator_for(spec, conf["Radios"]["Rx"]["UHF-H"]["frequency_Hz"])
    # the whole burst (preamble + sync + length + payload + CRC) must
    # fit inside one block for the single-block decode check
    n_bytes = max(4, min(16, spec.Nfft // (8 * int(round(spec.spsym))) - 24))
    payload = np.random.RandomState(1234).randint(0, 256, n_bytes).astype(np.uint8)
    rr_max = float(conf["Radios"]["rangeRateMax"])
    block, _ = burst_block(spec, mod, payload, 0.3 * rr_max, seed=7)
    rng = np.random.RandomState(8)
    blocks = [c2ri(block)] + [c2ri(noise(rng, spec.Nfft, 1e-2)) for _ in range(15)]
    for k in (3, 9):  # two more bursts at other Doppler offsets
        b, _ = burst_block(spec, mod, payload, (-0.5 if k == 3 else 0.6) * rr_max, seed=20 + k)
        blocks[k] = c2ri(b)

    lat = build_process_block(spec, latency_mode=True, packed=True)
    bat = build_process_block(spec, latency_mode=False, packed=True)
    bat_dict = build_process_block(spec, latency_mode=False)
    rl = unpack_block_outputs(np.asarray(lat(blocks[0])), spec)
    rb = unpack_block_outputs(np.asarray(bat(blocks[0])), spec)
    rd = {k: np.asarray(v) for k, v in bat_dict(blocks[0]).items()}
    keys = ("bits", "trust", "symbols", "centres", "mags")
    n = int(rl["nBits"])
    check(n == int(rb["nBits"]) and all(np.array_equal(rl[k][:n], rb[k][:n]) for k in keys),
          "latency graph != batch graph")
    say("c", "PASS latency graph == batch graph (bits/trust/symbols/centres/mags, bit-exact)")
    check(all(np.array_equal(rb[k].astype(np.float32), rd[k].astype(np.float32)) for k in keys),
          "packed outputs != dict outputs")
    say("c", "PASS packed outputs == dict outputs")
    followers = blocks[10:15]
    for name, g in (("latency", lat), ("batch", bat)):
        check(decode_blocks(conf, protocol, spec, g, [blocks[0]] + followers, payload),
              f"{name} graph did not decode the CC11xx packet CRC-clean")
    say("c", "PASS latency and batch graphs both decode the CC11xx packet CRC-clean")

    batch16 = build_process_batch(spec, packed=True)
    rows = np.asarray(batch16(np.stack(blocks)))
    worst = 0.0
    for k in range(len(blocks)):
        a = unpack_block_outputs(np.asarray(lat(blocks[k])), spec)
        b = unpack_block_outputs(rows[k], spec)
        bad = [q for q in DECISION_KEYS if not np.array_equal(a[q], b[q])]
        check(not bad, f"B=16 row {k} != single dispatch in {bad}")
        worst = max(worst, float(np.max(np.abs(a["mags"] - b["mags"])))
                    / max(float(np.max(np.abs(a["mags"]))), 1e-30))
    say("c", f"PASS every row of a B=16 batch == a single dispatch of that block "
             f"({', '.join(DECISION_KEYS)} bit-exact; mags max rel diff {worst:.3g})")


# ---------------------------------------------------------------- phase (d)


def make_air(conf, n_packets=10, seed=2024, snr_db=15.0, payload_len=32):
    """Seeded CC11xx air: ``n_packets`` bursts with Doppler offsets
    spread over 0.6 of the grid, over an AWGN floor, padded to a whole
    number of 16-hop batches. Returns (air, payloads).

    Each burst lies inside one hop, from 1/16 of it on. The block graph
    estimates Doppler and symbol timing once per block, so a burst part
    that falls in a block that is mostly noise can be lost (as in the
    reference algorithm); this phase checks the path, not that limit."""
    spec = cc11xx_spec(conf)
    mod = modulator_for(spec, conf["Radios"]["Rx"]["UHF-H"]["frequency_Hz"])
    sps = int(round(spec.spsym))
    hop = spec.Nfft - spec.sigOverlap
    # the CC11xx frame finder ends a frame after a fixed 267 bytes of
    # air, so bursts sit at least 300 bytes apart
    hops_apart = -(-300 * 8 * sps // hop)
    rr_max = float(conf["Radios"]["rangeRateMax"])
    rng = np.random.RandomState(seed)
    payloads = [rng.randint(0, 256, payload_len).astype(np.uint8) for _ in range(n_packets)]
    n_hops = -(-(n_packets * hops_apart + 2) // 16) * 16
    air = noise(rng, n_hops * hop, 1e-2)
    amp = np.float32(np.sqrt(1e-2 * 10 ** (snr_db / 10)))
    for k, (p, rr) in enumerate(zip(payloads, np.linspace(-0.6, 0.6, n_packets) * rr_max)):
        w = burst(mod, p, float(rr))
        s = k * hops_apart * hop + hop // 16
        check(len(w) <= hop - 2 * (hop // 16), f"burst of {len(w)} samples does not fit a hop")
        air[s:s + len(w)] += w * amp
    return air, payloads


def _decode_stream(conf, protocol, results):
    from pycusdr_tpu.decode import Decoder

    dec = Decoder(conf.get("decoder", {}), protocol)
    found, bits = [], []
    for r in results:
        bits.append(np.asarray(r["bits"]))
        pkts, _, _ = dec.findFrames(r["bits"], 0)
        for p in pkts:
            data, crcErr, _ = p.getBinaryData()
            found.append((bool(crcErr), np.asarray(data)))
    return found, np.concatenate(bits) if bits else np.zeros(0, np.uint8)


def phase_d(conf, n_packets=10):
    from pycusdr_tpu.models import UHF
    from pycusdr_tpu.protocol import loadProtocol

    protocol = loadProtocol("CC11xx")(conf=conf)
    air, payloads = make_air(conf, n_packets)
    streams = {}
    for path in ("dispatch/collect", "processMany", "processCapture"):
        demod = UHF.Demodulator(conf, protocol, "UHF-H")
        hop = demod.Nfft - demod.sigOverlap
        t_air = len(air) / demod.spec.sampleRate
        hops = air.reshape(-1, hop)
        t0 = time.time()
        if path == "dispatch/collect":
            # the runtime's depth-2 pipeline: block k+1 is dispatched
            # before block k is collected
            raw = demod.get_signalBufferHostPointer()
            results, pending = [], None
            for h in hops:
                raw[demod.sigOverlap:] = h
                handle = demod.dispatch(raw)
                raw[: demod.sigOverlap] = raw[-demod.sigOverlap:]
                if pending is not None:
                    results.append(demod.collect(pending))
                pending = handle
            results.append(demod.collect(pending))
        elif path == "processMany":
            results = []
            for i in range(0, len(hops), 16):
                results.extend(demod.processMany(hops[i:i + 16]))
        else:
            results = demod.processCapture(air)
        dt = time.time() - t0
        found, bits = _decode_stream(conf, protocol, results)
        clean = [d for err, d in found if not err]
        missing = [k for k, p in enumerate(payloads)
                   if not any(np.array_equal(d, p) for d in clean)]
        check(not missing, f"{path}: packets {missing} of {len(payloads)} not decoded CRC-clean")
        check(len(clean) == len(found), f"{path}: {len(found) - len(clean)} packets failed CRC")
        streams[path] = bits
        say("d", f"PASS {path}: {len(payloads)}/{len(payloads)} packets CRC-clean and "
                 f"bit-exact over {t_air:.2f} s of air ({len(hops)} blocks, host wall "
                 f"{dt:.2f} s incl. compile)")
    ref = streams["dispatch/collect"]
    for path, bits in streams.items():
        check(np.array_equal(bits, ref), f"{path} healed bit stream != dispatch/collect")
    say("d", f"PASS the three paths emit the same healed bit stream ({len(ref)} bits)")


# ---------------------------------------------------------------- phase (e)


def _pipeline_conf(base_port):
    conf = cc11xx_conf()
    conf["Radios"].pop("Tx")
    rx = conf["Radios"]["Rx"]["UHF-H"]
    rx["Interfaces"] = {"RxInPort": f"tcp://127.0.0.1:{base_port}",
                        "demodOut": f"tcp://localhost:{base_port + 1}"}
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{base_port + 1}",
        "demodOut": f"tcp://localhost:{base_port + 1}",
        "decodeOut": f"tcp://localhost:{base_port + 2}",
        "decodeIn": f"tcp://*:{base_port + 2}",
    })
    conf["Interfaces"]["External"] = {"decodeBytesOut_ZMQ": {"UHF": f"tcp://*:{base_port + 3}"}}
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=base_port + 4)
    conf["RPC"] = {"enabled": False}
    return conf


def gpu_pids():
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def phase_e(seconds=30.0, base_port=27700, warm_timeout=600.0):
    """The process pipeline, fed by the simulated front end."""
    import threading

    import zmq

    sys.path.insert(0, os.path.join(ROOT, "examples", "gnuradio"))
    import sim_frontend

    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = _pipeline_conf(base_port)
    out_dir = os.path.join(ROOT, ".chip_smoke")  # listed in .gitignore
    os.makedirs(out_dir, exist_ok=True)
    conf_path = os.path.join(out_dir, "chip_smoke_pipeline.json")
    with open(conf_path, "w") as f:
        json.dump(conf, f)
    seed, payload_len, interval = 4321, 48, 3.0

    sdr = PyCuSDR(dict(conf), args=None)
    ctx = zmq.Context()
    sink = ctx.socket(zmq.PULL)
    sink.connect(f"tcp://localhost:{base_port + 3}")
    sink.setsockopt(zmq.RCVTIMEO, 500)
    fe = threading.Thread(target=sim_frontend.main, daemon=True, args=([
        "-c", conf_path, "--snr", "15", "--interval", str(interval),
        "--duration", str(seconds), "--payload-len", str(payload_len),
        "--vary-payload", "--seed", str(seed)],))
    got = []
    try:
        sdr.start()
        demod = sdr.demodulators[0]
        t0 = time.time()
        while not demod.warmedFlag.wait(1.0):
            check(demod.is_alive(), "demod child died while compiling")
            check(time.time() - t0 < warm_timeout, "demod child not warm in time")
        warm_s = time.time() - t0
        # one compute process: the demod child (this process and the
        # decoder child stay off the card; inside a container the listed
        # pid is the host's, not the child's)
        pids = gpu_pids()
        check(len(pids) == 1, f"{len(pids)} processes on the card: {pids}")
        time.sleep(1.0)  # let the child subscribe before the feed starts
        fe.start()
        deadline = time.time() + seconds + 15.0
        while time.time() < deadline:
            try:
                got.append(sink.recv())
            except zmq.error.Again:
                continue
        fe.join(timeout=30.0)
        dead = [t.name for t in sdr.tasks if not t.is_alive()]
        check(not dead, f"pipeline processes died: {dead}")
    finally:
        sdr.terminate()
        sink.close(linger=0)
        ctx.term()
    n_sent = int((seconds - 1.0) // interval) + 1
    truths = [np.random.RandomState(seed + k).randint(0, 256, payload_len).astype(np.uint8)
              for k in range(n_sent)]
    wrong = [g for g in got if not any(np.array_equal(np.frombuffer(g, np.uint8), t)
                                       for t in truths)]
    check(not wrong, f"{len(wrong)} of {len(got)} packets on decodeBytesOut are not seeded payloads")
    check(len(got) >= n_sent - 2, f"only {len(got)} of ~{n_sent} bursts arrived as packets")
    say("e", f"PASS process pipeline: {len(got)} packets on decodeBytesOut from {n_sent} "
             f"simulated bursts, all bit-exact; demod child warm in {warm_s:.1f} s; "
             f"the card held exactly one process (the demod child)")


# ---------------------------------------------------------------- phase (a)


def phase_a(expect_count=None):
    import jax

    from pycusdr_tpu.utils.device_info import configure_compile_cache

    cache = configure_compile_cache()
    devs = jax.devices()
    check(all(d.platform == "gpu" for d in devs),
          f"JAX platform {devs[0].platform}, expected gpu")
    if expect_count is not None:
        check(len(devs) == expect_count, f"{len(devs)} GPUs, expected {expect_count}")
    say("a", f"PASS card: {card_line()}; JAX {jax.__version__}; devices {len(devs)} x "
             f"{devs[0].device_kind}; compile cache {cache}")
    return devs


# ---------------------------------------------------------------- four cards


def four_card_phase(spec, spec_deep, devices, n_hops=8):
    """Sharded programs against the single-device graph, decisions
    bit-for-bit: channel-only mesh, channel x dopp tensor split (at
    ``spec`` and the deep bank ``spec_deep``), time-sharded halo stream,
    on the first four of ``devices``."""
    import jax

    from pycusdr_tpu.dsp.block import build_process_block
    from pycusdr_tpu.ops.cfft import c2ri
    from pycusdr_tpu.parallel import build_sharded_demod_step, build_time_sharded_stream, make_mesh

    check(len(devices) >= 4, f"{len(devices)} devices, need 4")
    devices = devices[:4]

    def channel_blocks(sp, n, seed):
        mod = modulator_for(sp, 437.3e6)
        out = []
        for c in range(n):
            payload = np.random.RandomState(seed + c).randint(0, 256, 24).astype(np.uint8)
            b, _ = burst_block(sp, mod, payload, 600.0 * c, seed=seed + 10 + c)
            out.append(c2ri(b))
        return np.stack(out)

    def differing(res, i, single, block):
        """Decision outputs of row ``i`` of ``res`` that differ from the
        single-device graph on ``block``; per-slot outputs are compared
        over the block's own nBits slots (the sharded programs mark pad
        slots distrusted)."""
        ref = {k: np.asarray(v) for k, v in single(block).items()}
        n = int(ref["nBits"])
        bad = []
        for k in DECISION_KEYS:
            got = np.asarray(res[k])[i]
            if not np.array_equal(got[:n] if got.ndim else got,
                                  ref[k][:n] if got.ndim else ref[k]):
                bad.append(k)
        return bad

    for label, sp, shape in (("channel-only {channel:4, dopp:1}", spec, {"channel": 4, "dopp": 1}),
                             ("tensor split {channel:2, dopp:2} M=%d" % spec.num_masks, spec,
                              {"channel": 2, "dopp": 2}),
                             ("tensor split {channel:2, dopp:2} M=%d" % spec_deep.num_masks,
                              spec_deep, {"channel": 2, "dopp": 2})):
        mesh = make_mesh(shape, devices)
        step = build_sharded_demod_step(sp, mesh)
        blocks = channel_blocks(sp, shape["channel"] * 2, seed=300)
        t0 = time.time()
        res = jax.block_until_ready(step(blocks))
        dt = time.time() - t0
        single = build_process_block(sp)
        for c in range(blocks.shape[0]):
            bad = differing(res, c, single, blocks[c])
            check(not bad, f"{label}: channel {c} differs from the single-device graph in {bad}")
        say("4", f"PASS {label} (Nfft {sp.Nfft}, D {sp.D}): decisions == single device, "
                 f"{blocks.shape[0]} channels (first call {dt:.1f} s incl. compile)")

    tmesh = make_mesh({"time": 4}, devices)
    stream = build_time_sharded_stream(spec, tmesh)
    hop = spec.Nfft - spec.sigOverlap
    ov = spec.sigOverlap
    mod = modulator_for(spec, 437.3e6)
    rng = np.random.RandomState(77)
    air = noise(rng, n_hops * hop, 1e-2)
    amp = np.float32(np.sqrt(1e-2 * 10 ** 1.5))
    for k in range(0, n_hops, 2):
        payload = rng.randint(0, 256, 24).astype(np.uint8)
        s0 = k * hop + hop // 8
        w = burst(mod, payload, 400.0 * k)[: len(air) - s0]
        air[s0:s0 + len(w)] += w * amp
    new = c2ri(air.reshape(n_hops, hop))
    carry = np.zeros((2, ov), np.float32)
    res, carry_out = jax.block_until_ready(stream(new, carry))
    single = build_process_block(spec)
    prev = carry
    for k in range(n_hops):
        block = np.concatenate([prev, new[k]], axis=-1)
        bad = differing(res, k, single, block)
        check(not bad, f"halo stream block {k} differs from the single-device graph in {bad}")
        prev = block[:, -ov:]
    check(np.array_equal(np.asarray(carry_out), prev), "halo stream carry differs")
    say("4", f"PASS time-sharded halo stream {{time:4}}: {n_hops} blocks == sequential "
             f"single-device overlap-save")


# ---------------------------------------------------------------- main


def result_line(devs):
    return json.dumps({"ok": True, "device": {"platform": devs[0].platform,
                                              "kind": devs[0].device_kind,
                                              "count": len(devs)}})


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-card phase, on four GPUs")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    card = card_line()  # no NVIDIA driver -> no card -> fail here
    say("-", f"card (nvidia-smi name, power limit): {card}")

    if args.four_cards:
        devs = phase_a(expect_count=4)
        import __graft_entry__ as g

        four_card_phase(g.flagship_spec(), g.flagship_spec(mask_size=5), devs)
    else:
        try:
            import zmq  # noqa: F401
        except ImportError:
            say("e", "SKIP process pipeline: pyzmq is not installed on this host")
        else:
            phase_e()
        devs = phase_a()
        phase_b()
        conf = cc11xx_conf()
        phase_c(conf)
        phase_d(conf)
    say("-", f"card (nvidia-smi name, power limit): {card_line()}")
    print(result_line(devs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
