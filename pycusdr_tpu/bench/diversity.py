"""Diversity (softCombiner vote) gain measurement.

The reference system's core selling point is that N antenna channels
with independent noise, voted bit-by-bit in the softCombiner, decode
packets a single channel cannot (``softCombiner.py:10``). This harness
quantifies it on the REAL process pipeline (spawned demods -> combiner
-> decoder over ZMQ, ``bench/ber.py`` engine): at each SNR it runs the
same seeded packet through a 1-channel arm and a 3-channel voted arm
(per-channel independent AWGN, reference
``config/benchmark/bench_3_chan_rx_base.json`` analog) and reports
packet count + BER for both.

Run: python -m pycusdr_tpu.bench.diversity [--snrs -2 -1 0 1] [--runs 10]
"""

import argparse
import json

import numpy as np


def run_diversity(modulation="FSK", snrs=(-2.0, -1.0, 0.0, 1.0), runs=10,
                  packetLen=10000, basePort=27200, fsSimFactor=6.0,
                  fsSimFactor3=0.5, out_path=None, verbose=True):
    from pycusdr_tpu.bench.ber import run_ber_sweep

    # the 3-channel arm is paced much slower: three demod children on a
    # shared host must each hold real-time margin, or they stall and
    # skew apart and the measurement becomes one of host contention,
    # not diversity (the single-channel arm has no such constraint)
    arms = {}
    for nd, port, fac in ((1, basePort, fsSimFactor),
                          (3, basePort + 400, fsSimFactor3)):
        arms[nd] = run_ber_sweep(
            modulation, nRuns=runs, snrs=list(snrs), nDemodulators=nd,
            packetLen=packetLen, basePort=port, fsSimFactor=fac,
        )

    rows = []
    for i, snr in enumerate(snrs):
        row = {
            "modulation": modulation, "snr_db": float(snr), "runs": runs,
            "packets_1ch": arms[1]["numPackets"][i],
            "ber_1ch": arms[1]["BER"][i],
            "packets_3ch_voted": arms[3]["numPackets"][i],
            "ber_3ch_voted": arms[3]["BER"][i],
        }
        rows.append(row)
        if verbose:
            print(json.dumps(row), flush=True)

    if out_path:
        np.savez(out_path, rows=json.dumps(rows),
                 meta=json.dumps({"packetLen": packetLen, "runs": runs,
                                  "modulation": modulation,
                                  "noise": "independent per channel"}))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--modulation", default="FSK")
    ap.add_argument("--snrs", type=float, nargs="+", default=[-2.0, -1.0, 0.0, 1.0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--packetLen", type=int, default=10000)
    ap.add_argument("--basePort", type=int, default=27200)
    ap.add_argument("--out", default=None)
    ap.add_argument("--cpu", action=argparse.BooleanOptionalAction, default=True,
                    help="run on the CPU backend (--no-cpu targets the GPU)")
    args = ap.parse_args()
    if args.cpu:
        import os

        os.environ.setdefault("PYCUSDR_JAX_PLATFORM", "cpu")
        import jax

        jax.config.update("jax_platforms", "cpu")
    run_diversity(args.modulation, tuple(args.snrs), args.runs,
                  packetLen=args.packetLen, basePort=args.basePort,
                  out_path=args.out)


if __name__ == "__main__":
    main()
