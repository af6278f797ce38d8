"""On-hardware validation + throughput of the auxiliary device subsystems.

Covers the two device-side capabilities that are new over the reference
(BASELINE configs #5 and #3) and are otherwise only exercised on the
CPU test mesh:

* the polyphase channelizer front-end (``parallel/channelizer.py``) —
  validated by a tone-splitting check (a carrier at channel c's centre
  must land its energy in channel c) and timed as sustained wideband
  Msamples/s,
* the LEO Doppler search-and-track loop (``models/tracking.py``) —
  driven over a simulated pass whose Doppler follows the classic
  S-curve, reporting lock fraction and tracking error, plus the
  measured per-block speedup of the narrow track grid vs the full
  acquisition grid.

Timing uses the same paired scan-chain method as ``bench.py`` (T vs 2T
chains, host fetch, every output consumed).

Run: ``python -m pycusdr_tpu.bench.subsystems [--cpu] [--out f.json]``.
"""

import argparse
import json

import numpy as np


def channelizer_bench(M: int = 64, taps_per_branch: int = 8,
                      n_samples: int = 65536, batches=(1, 4), T: int = 30):
    """Validate + time the M-channel PFB on the current backend."""
    import jax.numpy as jnp

    from pycusdr_tpu.bench.profile_stages import stage_seconds
    from pycusdr_tpu.ops.cfft import c2ri
    from pycusdr_tpu.parallel.channelizer import Channelizer

    ch = Channelizer(M, taps_per_branch, jit=False)
    state0 = jnp.asarray(ch.init_state())

    # --- validity: a tone at channel c's centre lands in channel c ---
    c = min(5, M - 1)
    n = np.arange(n_samples)
    tone = np.exp(2j * np.pi * (c / M) * n).astype(np.complex64)
    y, _ = ch._apply(jnp.asarray(c2ri(tone)), state0)
    y = np.asarray(y)
    energy = (y ** 2).sum(axis=(1, 2))
    purity = float(energy[c] / energy.sum())
    assert np.isfinite(y).all(), "channelizer output not finite on this backend"
    assert purity > 0.9, f"tone leaked across channels (purity {purity:.3f})"

    def fn(x_ri):
        yy, st = ch._apply(x_ri, state0)
        return (yy.astype(jnp.float32) ** 2).sum() + st.sum()

    rng = np.random.RandomState(0)
    x = c2ri((rng.randn(n_samples) + 1j * rng.randn(n_samples))
             .astype(np.complex64))
    rows = {}
    for B in batches:
        dt = stage_seconds(fn, [x], B, T=T)
        rows[f"B{B}"] = {
            "us_per_call": round(dt / B * 1e6, 1),
            "wideband_msps": round(B * n_samples / dt / 1e6, 1),
        }
    return {"M": M, "taps_per_branch": taps_per_branch,
            "n_samples": n_samples, "tone_purity": round(purity, 4),
            "throughput": rows}


def _s_curve_blocks(spec, n_blocks, f_max, t_mid, tau, snr_db=10.0, seed=3):
    """FSK blocks under an S-curve Doppler pass; returns (blocks, truth_hz)."""
    from pycusdr_tpu.dsp.signal_gen import awgn, modulate_fsk

    N, fs = spec.Nfft, spec.sampleRate
    rng = np.random.RandomState(seed)
    nbits = (N * n_blocks) // int(spec.spsym) + 8
    base = modulate_fsk(rng.randint(0, 2, nbits), int(spec.spsym))
    base = base[: N * n_blocks]
    t_blk = np.arange(N * n_blocks) / N  # time in blocks
    f_inst = spec.centreFreqOffset - f_max * np.tanh((t_blk - t_mid) / tau)
    phase = 2 * np.pi * np.cumsum(f_inst) / fs
    sig = (base * np.exp(1j * phase)).astype(np.complex64)
    sig = awgn(sig, snr_db, rng=rng)
    truth = spec.centreFreqOffset - f_max * np.tanh(
        (np.arange(n_blocks) + 0.5 - t_mid) / tau)
    return sig.reshape(n_blocks, N), truth


def tracking_bench(spec=None, n_blocks: int = 400, track_bins: int = 16,
                   track_span_bins: int = 32, snr_db: float = 10.0,
                   time_graphs: bool = True, T: int = 50):
    """Drive a full simulated LEO pass through the search-and-track loop
    on the current backend; optionally time acquire vs track graphs.

    The S-curve's swing is sized by two physical constraints: stay well
    inside the acquisition grid (<= 0.7 of its Hz span), and keep the
    per-block Doppler slew followable by the narrow track grid (<= 0.4
    of its half-span per block, so the ramp prediction holds the truth
    inside the grid). Whichever binds is reported as
    ``swing_fraction_of_grid`` — with the default 400-block pass and the
    flagship envelope the slew constraint binds, exactly as in a real
    pass (LEO slew is ~tens of Hz per 0.4 s block at UHF while the
    acquisition grid spans tens of kHz)."""
    from pycusdr_tpu.models.tracking import TRACKING, DopplerTracker
    from pycusdr_tpu.ops.cfft import c2ri

    if spec is None:
        import __graft_entry__ as g

        spec = g.flagship_spec()

    tracker = DopplerTracker(spec=spec, track_bins=track_bins,
                             track_span_bins=track_span_bins,
                             snr_threshold_db=3.0, lost_limit=5)
    bin_hz = spec.sampleRate / spec.Nfft
    grid_span_hz = float(spec.dopp_hz_lut.max() - spec.dopp_hz_lut.min())
    tau = n_blocks / 6
    slew_limit = 0.4 * (track_span_bins / 2) * bin_hz  # Hz per block
    f_max = min(0.35 * grid_span_hz, slew_limit * tau)
    blocks, truth = _s_curve_blocks(spec, n_blocks, f_max,
                                    t_mid=n_blocks / 2, tau=tau,
                                    snr_db=snr_db)
    modes, est = [], []
    for b in blocks:
        res = tracker.process(c2ri(b))
        modes.append(res["mode"])
        est.append(float(res["doppler_hz"]))

    locked = [m == TRACKING for m in modes]
    assert any(locked), "tracker never locked during the pass"
    first = locked.index(True)
    lock_frac = float(np.mean(locked[first:]))
    err_bins = np.abs(np.asarray(est)[first:] - truth[first:]) / bin_hz
    out = {
        "n_blocks": n_blocks,
        "doppler_swing_hz": round(2 * f_max, 1),
        "swing_fraction_of_grid": round(2 * f_max / grid_span_hz, 4),
        "max_slew_hz_per_block": round(f_max / tau, 2),
        "snr_db": snr_db,
        "first_lock_block": first,
        "lock_fraction_after_first": round(lock_frac, 3),
        "median_err_bins": round(float(np.median(err_bins)), 3),
        "acquire_bins": int(spec.num_dopplers),
        "track_bins": int(tracker.track_spec.num_dopplers),
    }

    if time_graphs:
        from pycusdr_tpu.bench.profile_stages import stage_seconds
        from pycusdr_tpu.dsp.block import build_process_block
        from pycusdr_tpu.ops.cfft import c2ri as _c2ri

        import jax.numpy as jnp

        def consume(r):
            return (r["bits"].sum() + r["centres"].sum()).astype(jnp.float32) \
                + r["mags"].sum() + r["doppler_hz"] \
                + jnp.nan_to_num(r["snr_db"], neginf=-1.0)

        # the same single-block (latency-mode) graphs the tracker itself
        # dispatches, rebuilt unjitted for the scan-chain timer
        acq = build_process_block(spec, jit=False, latency_mode=True)
        trk = build_process_block(tracker.track_spec, jit=False,
                                  latency_mode=True)
        sig = _c2ri(np.asarray(blocks[0]))
        t_acq = stage_seconds(lambda x: consume(acq(x)), [sig], 1, T=T)
        t_trk = stage_seconds(
            lambda x, ctr: consume(trk(x, ctr)), [sig, np.int32(0)], 1, T=T)
        out["acquire_us_per_block"] = round(t_acq * 1e6, 1)
        out["track_us_per_block"] = round(t_trk * 1e6, 1)
        out["track_speedup"] = round(t_acq / t_trk, 2)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--blocks", type=int, default=48)
    args = ap.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    res = {
        "channelizer": channelizer_bench(),
        "tracking": tracking_bench(n_blocks=args.blocks),
    }
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
