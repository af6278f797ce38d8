"""Headline benchmark: flagship UHF demod throughput on one GPU.

Run on a machine with the card: ``python bench.py``. It prints the
card's name and power limit (``nvidia-smi``) and JAX's device kind on
one line, then ONE JSON line:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...}
It refuses to run when JAX's device is not a GPU.

Metric: sustained demodulation throughput of the full per-block chain
(FFT → 64-bin Doppler search → matched filtering → symbol timing →
symbol detection → soft bits) at the operational UHF envelope
(Nfft 2^16, overlap 2^10), counting effective (non-overlap) samples.

Method: T iterations of the block chain run inside one jitted
``lax.scan`` whose carry feeds each iteration's input (so XLA cannot
hoist or dedupe the body), and a host fetch of the final scalar is
timed; a paired T vs 2T difference removes the fixed dispatch + fetch
cost. This is a device-only rate of one layer, not an end-to-end
figure.

Batch realism: a production ground station demodulates many co-sampled
channels per dispatch (the polyphase channelizer emits dozens), so the
sustained rate is measured at batch 1 / 16 / 64 vmapped blocks and the
best rate is reported.

vs_baseline: measured throughput divided by the BASELINE.json target of
10x the CPU-reference implementation (the numpy transliteration of the
reference hot path, ``pycusdr_tpu.dsp.reference.demod_block_numpy``,
timed on this host). vs_baseline >= 1.0 means the north-star target
"≥10× CPU-reference Msamples/s/chip" is met.
"""

import json
import time

import numpy as np


def time_fn(fn, n_iter, *args):
    t0 = time.perf_counter()
    for _ in range(n_iter):
        out = fn(*args)
    return (time.perf_counter() - t0) / n_iter, out


def sustained_msps(core, spec, B, T=10, repeats=5, chunked=True):
    """Sustained rate: T scan-chained batches per fetch, with the
    per-fetch overhead removed by a paired T vs 2T difference (both are
    real host fetches, so the measurement proves device execution); the
    median over repeats rejects load variance.
    """
    import jax
    import jax.numpy as jnp

    if chunked:
        # production batch evaluation: chunk-unrolled past BATCH_CHUNK
        # (dsp.block.build_process_batch)
        from pycusdr_tpu.dsp.block import build_process_batch

        vc = build_process_batch(spec, jit=False)
    else:
        vc = jax.vmap(core)
    eff = spec.Nfft - spec.sigOverlap

    def make(Tn):
        @jax.jit
        def bench_fn(batch):
            def body(carry, _):
                out = vc(batch + carry * jnp.float32(1e-30))
                # consume EVERY output family: a probe that only reads
                # nBits (a function of spSym alone) lets XLA dead-code-
                # eliminate the entire symbol-detection tree + bit
                # extraction, and the "full chain" rate silently becomes
                # a partial-chain rate
                used = (
                    out["nBits"].sum().astype(jnp.float32)
                    + out["bits"].sum().astype(jnp.float32)
                    + out["trust"].sum().astype(jnp.float32)
                    + out["symbols"].sum().astype(jnp.float32)
                    + out["centres"].sum().astype(jnp.float32)
                    + out["mags"].sum()
                    + out["doppler_hz"].sum()
                    # noise blocks report SNR -inf by design; keep the
                    # carry finite
                    + jnp.nan_to_num(out["snr_db"], neginf=-1.0).sum()
                )
                c2 = carry + used * jnp.float32(1e-30)
                return c2, None

            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=Tn)
            return c

        return bench_fn

    rng = np.random.RandomState(1)
    from pycusdr_tpu.ops.cfft import c2ri

    blocks = (
        rng.randn(B, spec.Nfft) + 1j * rng.randn(B, spec.Nfft)
    ).astype(np.complex64)
    d = jax.device_put(np.stack([c2ri(b) for b in blocks]))
    from pycusdr_tpu.bench.profile_stages import measure_paired

    f1, f2 = make(T), make(2 * T)
    per_iter = measure_paired(lambda: f1(d), lambda: f2(d), T,
                              repeats=repeats)
    return B * eff / per_iter / 1e6


def main():
    import subprocess

    import jax

    from pycusdr_tpu.utils.device_info import configure_compile_cache

    configure_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX's device is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"device: {dev.device_kind} x {len(jax.devices())}; card (name, power limit): {card}",
          flush=True)
    from __graft_entry__ import flagship_spec
    from pycusdr_tpu.dsp.block import build_process_block
    from pycusdr_tpu.dsp.reference import demod_block_numpy

    spec = flagship_spec()
    core = build_process_block(spec, jit=False)
    eff_samples = spec.Nfft - spec.sigOverlap

    # two batched shapes: 16 ~ a multi-antenna station, 64 ~ a
    # channelizer bank; B=1 (single streamed channel) uses a longer
    # chain so the paired difference has signal over the fetch-RTT
    # jitter (the RTT itself — latency, not throughput — cancels in
    # the pairing; a streaming deployment pipelines dispatches)
    per_batch = {B: sustained_msps(core, spec, B) for B in (16, 64)}
    msps = max(per_batch.values())
    best_B = max(per_batch, key=per_batch.get)
    # B=1 runs the single-block streaming graph (same routes as the
    # batch form — see dsp/block.py); T=100 gives the paired difference
    # signal over the fetch jitter
    core_lat = build_process_block(spec, jit=False, latency_mode=True)
    msps_b1 = sustained_msps(core_lat, spec, 1, T=100, chunked=False)

    # --- CPU reference (numpy transliteration of the reference chain) ---
    rng = np.random.RandomState(0)
    block = (
        rng.randn(spec.Nfft).astype(np.float32)
        + 1j * rng.randn(spec.Nfft).astype(np.float32)
    ).astype(np.complex64)
    demod_block_numpy(spec, block)  # warm-up (first call pays page-in costs)
    cpu_dt = min(time_fn(lambda b: demod_block_numpy(spec, b), 1, block)[0]
                 for _ in range(3))  # min-of-runs rejects host contention
    cpu_msps = eff_samples / cpu_dt / 1e6

    target = 10.0 * cpu_msps
    print(
        json.dumps(
            {
                "metric": "uhf_demod_throughput_per_chip",
                "value": round(msps, 3),
                "unit": "Msamples/s",
                "vs_baseline": round(msps / target, 3),
                # publish every batch point so the headline is
                # decomposable, not a silent max()
                "best_batch": best_B,
                "b16_msps": round(per_batch[16], 3),
                "b64_msps": round(per_batch[64], 3),
                "batch1_msps": round(msps_b1, 3),
                # north-star second metric (BASELINE.json): Doppler
                # hypotheses evaluated per second at the SHIPPED route
                # (pruned-output DFT) = D grid shifts x blocks/s at the
                # headline rate, each hypothesis scoring the full
                # 2^16-bin spectrum
                "doppler_hyp_evals_per_s": round(
                    spec.D * msps * 1e6 / eff_samples, 1),
                "cpu_reference_msps": round(cpu_msps, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
