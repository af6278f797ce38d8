"""BER waterfall with a reference arm: device chain vs numpy golden on
IDENTICAL noisy signals.

BASELINE.json's north-star metric is "BER delta vs reference at fixed
SNR". The reference implementation needs a CUDA GPU, but
``dsp.reference`` is a declared numpy transliteration of its hot path
(golden-tested block-by-block), so it serves as the reference arm
without one: every (modulation, SNR, run) generates ONE deterministic
noisy 10,000-bit packet (reference packet length,
``create_signals.py:10-26``) and streams the SAME samples through

* arm A — the jitted block graph (``dsp.block``), and
* arm B — the numpy golden chain (``dsp.reference``),

both wrapped in the SAME streaming frontend (``models.Demodulator``
overlap-save + block healing) and the same frame finder, so any BER
difference is attributable to the device math alone.

Run:  python -m pycusdr_tpu.bench.ber_delta --out results/ber_delta.npz
"""

import argparse
import json
import os

import numpy as np

from pycusdr_tpu.config.loader import load_modular_json

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "config", "configs")

DEFAULT_SNRS = {
    "FSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
    "GFSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
    "GMSK": (2.0, 3.0, 4.0, 5.0, 6.0, 8.0, 10.0),
    "BPSK": (0.0, 1.0, 2.0, 3.0, 4.0, 6.0, 8.0),
}


def _golden_process_block(spec):
    """Adapter: numpy golden chain presented as the jitted graph's
    result-dict interface, so ``models.Demodulator`` can run it as a
    drop-in ``_process_block``."""
    from pycusdr_tpu.dsp.reference import demod_block_numpy
    from pycusdr_tpu.ops.cfft import ri2c

    def process(block_ri):
        out = demod_block_numpy(spec, ri2c(np.asarray(block_ri)))
        bits = np.asarray(out["bits"], np.int8)
        n = len(bits)
        return {
            "bits": bits,
            "trust": np.asarray(out["trust"], np.int8)[:n],
            "symbols": np.asarray(out["symbols"], np.int32),
            "centres": np.asarray(out["centres"], np.int32),
            "mags": np.asarray(out["mags"], np.float32),
            "nSym": len(out["symbols"]),
            "nBits": n,
            "spSym": out["spSym"],
            "codeOffset": out["codeOffset"],
            "dopp_idx": out["dopp_idx"],
            "quality_db": out["quality_db"],
            "doppler_hz": out["doppler_hz"],
            "freq_offset_hz": out["freq_offset_hz"],
            "snr_db": out["snr_db"],
            "shift": out["shift"],
            "E": out["E"] if out["E"] is not None else np.zeros(1, np.float32),
        }

    return process


def _make_arm(conf, protocol_name, golden: bool):
    from pycusdr_tpu.models import UHF
    from pycusdr_tpu.protocol import loadProtocol

    protocol = loadProtocol(protocol_name)(conf=conf)
    demod = UHF.Demodulator(conf, protocol, "UHF-H")
    if golden:
        demod._process_block = _golden_process_block(demod.spec)
    return demod, protocol


def _stream_one(demod, protocol, conf, sig, expected_bytes, n_bits):
    """Stream one noisy packet; return (bitErrors or None, found)."""
    from pycusdr_tpu.decode import Decoder
    from pycusdr_tpu.bench.ber import popcount_bit_errors

    decoder = Decoder(conf, protocol)
    step = demod.Nfft - demod.sigOverlap
    n_blocks = int(np.ceil(len(sig) / step)) + 2
    sig = np.r_[sig, np.zeros(n_blocks * step - len(sig) + step, np.complex64)]

    best = None
    pos = 0
    while pos + step <= len(sig):
        demod._signal_buffer[demod.sigOverlap:] = sig[pos : pos + step]
        demod.uploadAndFindCarrier()
        bits, centres, trust, spSymEst = demod.demodulate()
        pkts, _, _ = decoder.findFrames(bits, 0, trust=trust)
        for p in pkts:
            data, _err, _raw = p.getBinaryData()
            errs = popcount_bit_errors(
                bytes(bytearray(np.asarray(data, np.uint8))), expected_bytes)
            best = errs if best is None else min(best, errs)
        demod._signal_buffer[: demod.sigOverlap] = demod._signal_buffer[-demod.sigOverlap:]
        pos += step
    return best


def run_delta(modulations=("FSK", "GFSK", "GMSK", "BPSK"), snrs=None, runs=10,
              packetLen=10000, seed=123, spSym=16, baud=9600, blockSize=None,
              overlap=None, out_path=None, verbose=True, matmul_dtype=None):
    from pycusdr_tpu.bench.ber import modulation_bandwidth
    from pycusdr_tpu.dsp.signal_gen import awgn, get_padded_packet, packet_data

    fs = spSym * baud
    rows = []
    for mod in modulations:
        conf = load_modular_json(
            os.path.join(CONF_DIR, "benchmark", f"bench_{mod}.json"))
        conf["Main"].update(PacketLen=packetLen, RandSeed=seed,
                            protocols={"UHF": f"bench_{mod}"})
        # blockSize None keeps each config's operational envelope (2^15
        # for the bench configs); 2^13 is ~4x faster in the numpy golden
        # arm but costs GMSK/BPSK real sensitivity (only 512 symbols of
        # Doppler/timing integration per block)
        if blockSize is not None:
            conf["GPU"]["UHF"]["blockSize"] = blockSize
        if overlap is not None:
            conf["GPU"]["UHF"]["overlap"] = overlap
        if matmul_dtype is not None:
            # arm A only by construction: the golden arm is numpy f64/f32
            # and never touches the device contraction
            conf["GPU"]["UHF"]["matmulDtype"] = matmul_dtype

        arm_a, proto_a = _make_arm(conf, f"bench_{mod}", golden=False)
        arm_b, proto_b = _make_arm(conf, f"bench_{mod}", golden=True)

        bits = packet_data(packetLen, seed)
        clean, _ = get_padded_packet(mod, spSym, fs, offset_freq=38400,
                                     raw_bits=bits, pad=8000)
        clean = clean.astype(np.complex64)
        expected = bytes(bytearray(proto_a.Packet(bits).getBinaryData()[0]))
        n_bits = len(bits)
        bw = modulation_bandwidth(mod, baud)

        for snr in snrs.get(mod, DEFAULT_SNRS[mod]) if isinstance(snrs, dict) \
                else (snrs or DEFAULT_SNRS[mod]):
            snr_raw = snr + 10 * np.log10(bw / fs)
            errs_a, errs_b, found_a, found_b = [], [], 0, 0
            for r in range(runs):
                # stable cross-process seed (Python's str hash is salted)
                import zlib

                key = zlib.crc32(f"{mod}:{snr:.1f}:{r}".encode())
                rng = np.random.RandomState(key % 2**31)
                noisy = awgn(clean, snr_raw, rng=rng).astype(np.complex64)
                ea = _stream_one(arm_a, proto_a, conf, noisy, expected, n_bits)
                eb = _stream_one(arm_b, proto_b, conf, noisy, expected, n_bits)
                if ea is not None:
                    errs_a.append(ea)
                    found_a += 1
                if eb is not None:
                    errs_b.append(eb)
                    found_b += 1
            ber_a = float(np.sum(errs_a) / (max(found_a, 1) * n_bits))
            ber_b = float(np.sum(errs_b) / (max(found_b, 1) * n_bits))
            row = {
                "modulation": mod, "snr_db": float(snr),
                "ebn0_db": float(snr + 10 * np.log10(bw / baud)),
                "runs": runs,
                "found_device": found_a, "found_golden": found_b,
                "ber_device": ber_a, "ber_golden": ber_b,
                "ber_delta": ber_a - ber_b,
                "bit_errors_device": errs_a, "bit_errors_golden": errs_b,
            }
            rows.append(row)
            if verbose:
                print(json.dumps(row), flush=True)

    if out_path:
        np.savez(out_path, rows=json.dumps(rows),
                 meta=json.dumps({"packetLen": packetLen, "seed": seed,
                                  "spSym": spSym, "baud": baud,
                                  "blockSize": blockSize, "runs": runs}))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modulations", nargs="+",
                    default=["FSK", "GFSK", "GMSK", "BPSK"])
    ap.add_argument("--snrs", type=float, nargs="+", default=None)
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--packetLen", type=int, default=10000)
    ap.add_argument("--blockSize", type=int, default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--matmul-dtype", default=None,
                    choices=["float32", "bfloat16"],
                    help="route arm A's Doppler contraction through this "
                         "operand dtype (the gate for shipping the bf16 "
                         "route; see ops/doppler_search.py MATMUL_DTYPE)")
    ap.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=True,
                    help="run on the CPU backend (--no-cpu targets the GPU)")
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    run_delta(tuple(args.modulations), args.snrs, args.runs,
              packetLen=args.packetLen, blockSize=args.blockSize,
              out_path=args.out, matmul_dtype=args.matmul_dtype)


if __name__ == "__main__":
    main()
