"""Per-stage device-time profile of the flagship block graph.

Every number comes from T scan-chained iterations inside ONE jitted
computation whose carry feeds each iteration's input (no hoisting/CSE
possible) followed by a host fetch of the final scalar, with a paired
T vs 2T difference removing the fixed dispatch + fetch cost. Reported
per-iteration time includes the backend's fixed per-scan-step overhead;
an empty-body scan is measured alongside to expose that floor.

Run on the card:  python -m pycusdr_tpu.bench.profile_stages
Options: --batches 1 64   --T 10   --out results/profile_stages.json
"""

import argparse
import json
import time

import numpy as np


def measure_paired(bench1, bench2, T, repeats=5):
    """Per-iteration seconds from a paired T vs 2T chain difference.

    A single timed fetch includes the dispatch + fetch round trip; the
    back-to-back difference cancels it (both fetches still prove device
    execution). Median over repeats rejects load variance.
    """
    float(bench1())  # compile + warm
    float(bench2())
    deltas = []
    last2 = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(bench1())
        t1 = time.perf_counter()
        float(bench2())
        t2 = time.perf_counter()
        deltas.append((t2 - t1) - (t1 - t0))
        last2 = min(last2, t2 - t1)
    per_iter = float(np.median(deltas)) / T
    if per_iter <= 0:  # load spike mid-pair; fall back to the 2T chain
        per_iter = last2 / (2 * T)
    return per_iter


def measure_ab(a1, a2, b1, b2, T, repeats=7):
    """Drift-robust A/B: per repeat, time A's T and 2T chains AND B's T
    and 2T chains back-to-back in ONE window, form each arm's paired
    difference, and take the median of per-window B/A ratios: pairing
    inside one window cancels the drift that a sequential A-then-B
    comparison reads as a difference. Returns (sec_A, sec_B, ratio_B_over_A) medians."""
    for f in (a1, a2, b1, b2):
        float(f())
    das, dbs, ratios = [], [], []
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(a1())
        t1 = time.perf_counter()
        float(a2())
        t2 = time.perf_counter()
        float(b1())
        t3 = time.perf_counter()
        float(b2())
        t4 = time.perf_counter()
        da = (t2 - t1) - (t1 - t0)
        db = (t4 - t3) - (t3 - t2)
        if da > 0 and db > 0:
            das.append(da)
            dbs.append(db)
            ratios.append(db / da)
    if not ratios:
        return float("nan"), float("nan"), float("nan")
    return (float(np.median(das)) / T, float(np.median(dbs)) / T,
            float(np.median(ratios)))


def stage_seconds(fn, args, B, T=10, repeats=3):
    """Seconds per vmapped iteration of ``fn(*args)`` (B lanes, T chained).

    ``args``: numpy arrays WITHOUT the batch dim. Float inputs get the
    carry perturbation so the scan body cannot be hoisted; int inputs
    pass through untouched. ``fn`` must return a f32 scalar that
    consumes every output it produces (DCE defence).
    """
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(0)

    def tile(a):
        a = np.asarray(a)
        if np.issubdtype(a.dtype, np.floating):
            noise = rng.randn(B, *a.shape).astype(a.dtype) * (np.abs(a).mean() + 1e-3) * 0.01
            return np.broadcast_to(a, (B,) + a.shape) + noise
        return np.broadcast_to(a, (B,) + a.shape).copy()

    bat = [jax.device_put(tile(a)) for a in args]
    vf = jax.vmap(fn)

    def make(Tn):
        @jax.jit
        def bench_fn(*bat):
            def body(c, _):
                eps = c * jnp.float32(1e-30)
                pert = [b + eps if jnp.issubdtype(b.dtype, jnp.floating) else b
                        for b in bat]
                out = vf(*pert)
                return c + out.sum() * jnp.float32(1e-30), None

            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=Tn)
            return c

        return bench_fn

    f1, f2 = make(T), make(2 * T)
    return measure_paired(lambda: f1(*bat), lambda: f2(*bat), T,
                           repeats=max(repeats, 5))


def scan_floor(T=10, repeats=5):
    """Per-iteration cost of an empty scan body (backend fixed overhead,
    paired measurement so the fetch RTT is excluded)."""
    import jax
    import jax.numpy as jnp

    def make(Tn):
        @jax.jit
        def bench_fn(x):
            def body(c, _):
                return c * jnp.float32(1.0000001) + x, None

            c, _ = jax.lax.scan(body, jnp.float32(0.0), None, length=Tn)
            return c

        return bench_fn

    f1, f2 = make(T), make(2 * T)
    x = jnp.float32(1.0)
    return measure_paired(lambda: f1(x), lambda: f2(x), T, repeats)


def dispatch_rtt(repeats=5):
    """Single tiny dispatch + host fetch round trip."""
    import jax
    import jax.numpy as jnp

    f = jax.jit(lambda x: x * 2.0)
    x = jax.device_put(jnp.float32(1.0))
    float(f(x))
    best = np.inf
    for _ in range(repeats):
        t0 = time.perf_counter()
        float(f(x))
        best = min(best, time.perf_counter() - t0)
    return best


# ---------------------------------------------------------------------------


def build_prefix_fns_stx(spec, latency_mode=False, bank_route="fused"):
    """Cumulative-prefix closures for the STX graph (reference
    demodulator/STX.py semantics: spike clipping ON, NO Doppler search
    — the spectrum shift is the fixed ``dopp_offset_idx``)."""
    import jax.numpy as jnp

    from pycusdr_tpu.dsp.block import build_process_block
    from pycusdr_tpu.ops.cfft import c2ri, fft_ri
    from pycusdr_tpu.ops.demod_kernels import (
        apply_best_doppler_power,
        apply_best_doppler_power_cols,
        dilate_mask_dynamic,
        extract_bits_lut,
        find_centres,
        find_code_rate_and_phase,
        find_code_rate_and_phase_from_power,
        threshold_input,
    )

    N, M = spec.Nfft, spec.num_masks
    assert not spec.doppler_search and not spec.disable_peak_thresholding
    masks_ri = jnp.asarray(c2ri(spec.masks_f))
    bitLUT = jnp.asarray(spec.bitLUT.astype(np.int8))
    shift = jnp.int32(spec.dopp_offset_idx)
    # gather in BOTH modes since the precision fix (see dsp/block.py)
    route = "gather"

    rng = np.random.RandomState(7)
    sig0 = c2ri((rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64))

    def upto(stop):
        def fn(sig):
            sig, clipped = threshold_input(sig, spec.peak_threshold_scale)
            if stop == "clip":
                return sig.sum() + clipped.sum().astype(jnp.float32)
            S = fft_ri(sig)
            if stop == "fft":
                return (S[0] ** 2 + S[1] ** 2).sum() \
                    + clipped.sum().astype(jnp.float32)
            off = spec.code_search_mask_offset
            if bank_route == "fused":
                colsum, Vcol, m_star = apply_best_doppler_power_cols(
                    S, masks_ri, shift, off, M - off)
                if stop == "bank":
                    return colsum.sum() + Vcol.sum() \
                        + m_star.sum().astype(jnp.float32) \
                        + clipped.sum().astype(jnp.float32)
                spSym, codeOffset, code_val = find_code_rate_and_phase_from_power(
                    colsum, spec.code_idx_lo, spec.code_idx_hi, N)
                P2, cols = None, (Vcol, m_star)
            else:
                P2 = apply_best_doppler_power(S, masks_ri, shift)
                if stop == "bank":
                    return P2.sum() + clipped.sum().astype(jnp.float32)
                spSym, codeOffset, code_val = find_code_rate_and_phase(
                    P2, spec.code_idx_lo, spec.code_idx_hi, N, off)
                cols = None
            if stop == "timing":
                tail = (P2.sum() * 0 if P2 is not None
                        else Vcol.sum() + m_star.sum().astype(jnp.float32))
                return spSym + codeOffset + code_val + tail \
                    + clipped.sum().astype(jnp.float32)
            spc_pre = jnp.maximum(spSym, float(spec.spsymMin))
            hw = 2 * jnp.ceil(spc_pre).astype(jnp.int32)
            clip_dil = dilate_mask_dynamic(clipped, hw)
            symbols, centres, mags, nSym, spc, at_win = find_centres(
                P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
                spsymMin=spec.spsymMin, numSymMax=spec.numSymMax,
                clip_mask=clip_dil, select_route=route,
                cols=cols, num_masks=M)
            if stop == "centres":
                return (symbols.sum() + centres.sum()
                        + at_win.sum()).astype(jnp.float32) + mags.sum() + spc
            bits = extract_bits_lut(symbols, bitLUT)
            return (bits.sum() + symbols.sum() + centres.sum()
                    + at_win.sum()).astype(jnp.float32) + mags.sum() + spc
        return fn

    core = build_process_block(spec, jit=False, latency_mode=latency_mode,
                               bank_route=bank_route)

    def s_full(sig):
        r = core(sig)
        return (r["bits"].sum() + r["trust"].sum() + r["centres"].sum()
                ).astype(jnp.float32) + r["spSym"] + r["mags"].sum()

    prefixes = {f"pre_{s}": (upto(s), [sig0])
                for s in ["clip", "fft", "bank", "timing", "centres", "bits"]}
    prefixes["full"] = (s_full, [sig0])
    return prefixes


def build_stage_fns(spec):
    """Stage closures mirroring dsp/block.py's flow, each returning a
    DCE-proof f32 scalar. Returns (stages, sample_inputs)."""
    import jax.numpy as jnp

    from pycusdr_tpu.dsp.block import CORR_ROUTE_MIN_D, build_process_block
    from pycusdr_tpu.ops.cfft import c2ri, fft_ri
    from pycusdr_tpu.ops.demod_kernels import (
        apply_best_doppler_power,
        compute_snr,
        dilate_mask_dynamic,
        extract_bits_lut,
        find_centres,
        find_code_rate_and_phase,
        threshold_input,
    )
    from pycusdr_tpu.ops.doppler_search import (
        doppler_energy_corr,
        doppler_energy_corr_dft,
        find_doppler_estimate,
        make_corr_dft_F,
        make_qf_ri,
    )

    N, M, D = spec.Nfft, spec.num_masks, spec.D
    assert D >= CORR_ROUTE_MIN_D, "profile assumes the corr doppler route"
    qf_ri = jnp.asarray(make_qf_ri(spec.masks_f))
    corr_F = jnp.asarray(make_corr_dft_F(spec.Nfft, spec.dopp_shifts))
    masks_ri = jnp.asarray(c2ri(spec.masks_f))
    dopp_shifts = jnp.asarray(spec.dopp_shifts.astype(np.int32))

    rng = np.random.RandomState(7)
    sig = c2ri((rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64))
    S = np.asarray(fft_ri(jnp.asarray(sig)))
    P = S[0] ** 2 + S[1] ** 2
    P2 = rng.rand(M, N).astype(np.float32)
    E0 = rng.rand(D, M).astype(np.float32)
    spSym = np.float32(spec.spsym)
    codeOffset = np.float32(0.37)

    def s_fft(sig):
        S = fft_ri(sig)
        return (S[0] ** 2 + S[1] ** 2).sum()

    def s_dopp(P):
        E = doppler_energy_corr_dft(P, qf_ri, corr_F)
        return E.sum()

    def s_dopp_all_lags(P):
        # the superseded all-N-lags FFT-correlation route, timed for
        # comparison (not what dsp/block.py dispatches)
        E = doppler_energy_corr(P, qf_ri, dopp_shifts, jnp.int32(0))
        return E.sum()

    def s_est(E):
        di, q = find_doppler_estimate(E, spec.num_dopplers,
                                      spec.dopp_array_offset, spec.sum_all_masks)
        return di + q

    def s_bank(S):
        P2 = apply_best_doppler_power(S, masks_ri, jnp.int32(17))
        return P2.sum()

    def s_timing(P2):
        sp, co, cv = find_code_rate_and_phase(
            P2, spec.code_idx_lo, spec.code_idx_hi, N, spec.code_search_mask_offset)
        return sp + co + cv

    def s_centres(P2, spSym, codeOffset):
        symbols, centres, mags, nSym, spc = find_centres(
            P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
            spsymMin=spec.spsymMin, numSymMax=spec.numSymMax)
        return (symbols.sum() + centres.sum()).astype(jnp.float32) + mags.sum() \
            + nSym.astype(jnp.float32) + spc

    clip0 = (rng.rand(N) > 0.999)

    def s_centres_clip(P2, spSym, codeOffset):
        # the shape the full graph actually runs: clip mask riding the tree
        symbols, centres, mags, nSym, spc, at_win = find_centres(
            P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
            spsymMin=spec.spsymMin, numSymMax=spec.numSymMax,
            clip_mask=jnp.asarray(clip0))
        return (symbols.sum() + centres.sum() + at_win.sum()
                ).astype(jnp.float32) + mags.sum() + nSym.astype(jnp.float32) + spc

    def s_clip(sig):
        out, hit = threshold_input(sig, spec.peak_threshold_scale)
        dil = dilate_mask_dynamic(hit, jnp.int32(2 * spec.spsym))
        return out.sum() + dil.sum().astype(jnp.float32)

    def s_snr(sig):
        absS = jnp.sqrt(sig[0] ** 2 + sig[1] ** 2)
        return compute_snr(absS, jnp.int32(100), jnp.int32(300),
                           spec.snr_window, N)

    sym0 = rng.randint(0, M, spec.numSymMax).astype(np.int32)
    bitLUT = (spec.bitLUT.astype(np.int8) if spec.bitLUT is not None
              else np.arange(M, dtype=np.int8) % 2)

    def s_bits(symbols):
        return extract_bits_lut(symbols, jnp.asarray(bitLUT)
                                ).sum().astype(jnp.float32)

    core = build_process_block(spec, jit=False)

    def s_full(sig):
        r = core(sig)
        return (r["bits"].sum() + r["trust"].sum() + r["centres"].sum()
                ).astype(jnp.float32) + r["spSym"] + r["doppler_hz"] + r["mags"].sum()

    stages = {
        "fft_fwd": (s_fft, [sig]),
        "dopp_energy": (s_dopp, [P]),
        "dopp_energy_all_lags": (s_dopp_all_lags, [P]),
        "dopp_est": (s_est, [E0]),
        "mask_bank": (s_bank, [S]),
        "timing": (s_timing, [P2]),
        "centres": (s_centres, [P2, spSym, codeOffset]),
        "centres_clip": (s_centres_clip, [P2, spSym, codeOffset]),
        "clip": (s_clip, [sig]),
        "snr": (s_snr, [sig]),
        "bits": (s_bits, [sym0]),
        "full": (s_full, [sig]),
    }
    return stages


def build_prefix_fns(spec, latency_mode=False, bank_route="fused"):
    """Cumulative prefixes of the REAL flagship graph (doppler search on,
    corr route, thresholding off, centre-bit LUT), each consuming every
    live intermediate. Incremental deltas between consecutive prefixes
    are the true in-graph cost of each stage INCLUDING fusion effects
    the isolated stage closures miss (e.g. the mask bank runs at a
    traced shift here, not a constant)."""
    import jax.numpy as jnp

    from pycusdr_tpu.dsp.block import CORR_ROUTE_MIN_D, build_process_block
    from pycusdr_tpu.ops.cfft import c2ri, fft_ri
    from pycusdr_tpu.ops.demod_kernels import (
        apply_best_doppler_power,
        apply_best_doppler_power_cols,
        compute_snr,
        extract_bits_lut,
        find_centres,
        find_code_rate_and_phase,
        find_code_rate_and_phase_from_power,
    )
    from pycusdr_tpu.ops.doppler_search import (
        doppler_energy_corr_dft,
        find_doppler_estimate,
        make_corr_dft_F,
        make_qf_ri,
    )

    N, M, D = spec.Nfft, spec.num_masks, spec.D
    assert D >= CORR_ROUTE_MIN_D and spec.disable_peak_thresholding \
        and spec.bitLUT is not None
    qf_ri = jnp.asarray(make_qf_ri(spec.masks_f))
    corr_F = jnp.asarray(make_corr_dft_F(N, spec.dopp_shifts))
    masks_ri = jnp.asarray(c2ri(spec.masks_f))
    dopp_shifts = jnp.asarray(spec.dopp_shifts.astype(np.int32))
    hz_lut = jnp.asarray(spec.dopp_hz_lut.astype(np.float32))
    bitLUT = jnp.asarray(spec.bitLUT.astype(np.int8))

    rng = np.random.RandomState(7)
    sig = c2ri((rng.randn(N) + 1j * rng.randn(N)).astype(np.complex64))

    def upto(stop):
        def fn(sig):
            S = fft_ri(sig)
            P = S[0] ** 2 + S[1] ** 2
            if stop == "fft":
                return P.sum()
            E = doppler_energy_corr_dft(P, qf_ri, corr_F)
            if stop == "dopp":
                return E.sum() + P.sum() * 0
            dopp_idx, quality_db = find_doppler_estimate(
                E, spec.num_dopplers, spec.dopp_array_offset, spec.sum_all_masks)
            lowIdx = jnp.clip(jnp.floor(dopp_idx).astype(jnp.int32), 0, D - 1)
            highIdx = jnp.clip(jnp.ceil(dopp_idx).astype(jnp.int32), 0, D - 1)
            frac = jnp.mod(dopp_idx, 1.0)
            doppler_hz = hz_lut[lowIdx] + (hz_lut[highIdx] - hz_lut[lowIdx]) * frac
            sh_signed = jnp.mod(dopp_shifts + N // 2, N) - N // 2
            sl = sh_signed[lowIdx].astype(jnp.float32)
            sh = sh_signed[highIdx].astype(jnp.float32)
            shift = jnp.mod(jnp.round(sl + (sh - sl) * frac).astype(jnp.int32), N)
            if stop == "est":
                return doppler_hz + quality_db + shift.astype(jnp.float32)
            absS = jnp.sqrt(P)
            snr_db = compute_snr(absS, dopp_shifts[lowIdx], dopp_shifts[highIdx],
                                 spec.snr_window, N)
            if stop == "snr":
                return doppler_hz + jnp.nan_to_num(snr_db, neginf=-99.0) \
                    + shift.astype(jnp.float32)
            off = spec.code_search_mask_offset
            if bank_route == "fused":
                colsum, Vcol, m_star = apply_best_doppler_power_cols(
                    S, masks_ri, shift, off, M - off)
                if stop == "bank":
                    return colsum.sum() + Vcol.sum() \
                        + m_star.sum().astype(jnp.float32) + doppler_hz
                spSym, codeOffset, code_val = find_code_rate_and_phase_from_power(
                    colsum, spec.code_idx_lo, spec.code_idx_hi, N)
                P2, cols = None, (Vcol, m_star)
            else:
                P2 = apply_best_doppler_power(S, masks_ri, shift)
                if stop == "bank":
                    return P2.sum() + doppler_hz
                spSym, codeOffset, code_val = find_code_rate_and_phase(
                    P2, spec.code_idx_lo, spec.code_idx_hi, N, off)
                cols = None
            if stop == "timing":
                # p2: P2 stays live through the timing consumer, so the
                # *0 only avoids an extra MN-read. fused: Vcol/m_star
                # are not consumed until the centres prefix — sum them
                # for REAL (an N-read, ~free) or XLA would DCE the
                # max/argmax reductions this prefix must include.
                tail = (P2.sum() * 0 if P2 is not None
                        else Vcol.sum() + m_star.sum().astype(jnp.float32))
                return spSym + codeOffset + code_val + doppler_hz + tail
            symbols, centres, mags, nSym, spc = find_centres(
                P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
                spsymMin=spec.spsymMin, numSymMax=spec.numSymMax,
                select_route="gather",  # post-precision-fix default
                cols=cols, num_masks=M)
            if stop == "centres":
                return (symbols.sum() + centres.sum()).astype(jnp.float32) \
                    + mags.sum() + spc + doppler_hz
            bits = extract_bits_lut(symbols, bitLUT)
            return (bits.sum() + symbols.sum() + centres.sum()
                    ).astype(jnp.float32) + mags.sum() + spc + doppler_hz \
                + jnp.nan_to_num(snr_db, neginf=-99.0) + quality_db
        return fn

    core = build_process_block(spec, jit=False, latency_mode=latency_mode,
                               bank_route=bank_route)

    def s_full(sig):
        r = core(sig)
        return (r["bits"].sum() + r["trust"].sum() + r["centres"].sum()
                ).astype(jnp.float32) + r["spSym"] + r["doppler_hz"] + r["mags"].sum()

    prefixes = {f"pre_{s}": (upto(s), [sig])
                for s in ["fft", "dopp", "est", "snr", "bank", "timing", "centres"]}
    prefixes["pre_bits"] = (upto("bits"), [sig])
    prefixes["full"] = (s_full, [sig])
    return prefixes


#: prefix name -> stages whose FLOPs are inside that cumulative prefix
def run_profile(batches=(1, 64), T=10, spec=None, mode="stages",
                latency_mode=False, bank_route="fused"):
    import jax

    if spec is None:
        from __graft_entry__ import flagship_spec

        spec = flagship_spec()

    if mode == "prefix":
        stages = (build_prefix_fns(spec, latency_mode, bank_route=bank_route)
                  if spec.doppler_search
                  else build_prefix_fns_stx(spec, latency_mode,
                                            bank_route=bank_route))
    else:
        stages = build_stage_fns(spec)
    eff = spec.Nfft - spec.sigOverlap

    result = {
        "device": str(jax.devices()[0]),
        "spec": {"Nfft": spec.Nfft, "D": spec.D, "M": spec.num_masks,
                 "windowWidth": spec.windowWidth, "numSymMax": spec.numSymMax},
        "bank_route": bank_route,
        "scan_floor_ms": round(scan_floor(T) * 1e3, 4),
        "dispatch_rtt_ms": round(dispatch_rtt() * 1e3, 4),
        "batches": {},
    }

    for B in batches:
        # small batches lengthen the chain so the paired difference has
        # signal over the fetch jitter
        T_b = max(T, 100 // B)
        rows = {}
        for name, (fn, args) in stages.items():
            sec = stage_seconds(fn, args, B, T=T_b)
            rows[name] = {"us_per_block": round(sec / B * 1e6, 1)}
        rows["full"]["msps"] = round(eff / rows["full"]["us_per_block"], 1)
        result["batches"][f"B{B}"] = rows
    return result


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 64])
    ap.add_argument("--T", type=int, default=10)
    ap.add_argument("--out", default=None)
    ap.add_argument("--mode", choices=["stages", "prefix"], default="stages",
                    help="stages: isolated stage closures; prefix: cumulative"
                         " prefixes of the real graph (deltas = true "
                         "in-graph incremental cost)")
    ap.add_argument("--latency-mode", action="store_true",
                    help="profile the latency-optimized (single-block "
                         "streaming) graph variant")
    ap.add_argument("--spec", choices=["flagship", "stx"], default="flagship",
                    help="graph envelope: flagship (UHF, Nfft 2^16, D=64) "
                         "or stx (Nfft 2^17, no Doppler search, clipping on)")
    ap.add_argument("--bank-route", choices=["fused", "p2"], default="fused",
                    help="matched-filter bank route: fused mask-axis "
                         "reductions (default) or the P2-materializing "
                         "pre-round-4 route (A/B)")
    args = ap.parse_args()

    spec = None
    if args.spec == "stx":
        from __graft_entry__ import stx_spec

        spec = stx_spec()
    res = run_profile(tuple(args.batches), args.T, spec=spec, mode=args.mode,
                      latency_mode=args.latency_mode,
                      bank_route=args.bank_route)
    print(json.dumps(res, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
