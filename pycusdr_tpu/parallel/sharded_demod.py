"""The multi-chip demodulation step: channels x doppler/mask sharding.

One jitted SPMD program replaces the reference's "one OS process + one
CUDA context per Rx channel" layout (``pyCuSDR.py:244-251``) and its
CPU softCombiner vote (``softCombiner.py:570-618``):

* the ``channel`` mesh axis shards Rx antenna channels (pure data
  parallelism — each shard runs the full per-channel chain),
* the ``dopp`` mesh axis shards the Doppler-bin grid during the carrier
  search and the matched-filter mask bank during demodulation (tensor
  parallelism over the search dimension). The only cross-shard traffic
  is tiny: an all-gather of the (D, M) energy matrix, a psum of the
  timing power waveform, an all-gather of per-slot window maxima, and
  the final all-gather of soft bits for the vote.

Per-stage parity citations are in ``pycusdr_tpu.ops`` / ``dsp.block``;
this module only adds the sharding decomposition.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from pycusdr_tpu.dsp.spec import DemodSpec
from pycusdr_tpu.ops.cfft import band_dft_real, c2ri, fft_ri
from pycusdr_tpu.ops.demod_kernels import (
    apply_best_doppler_power,
    compute_snr,
    threshold_input,
)
from pycusdr_tpu.ops.doppler_search import (
    doppler_energy_corr_dft,
    find_doppler_estimate,
    make_corr_dft_F,
    make_qf_ri,
)
from pycusdr_tpu.parallel.vote import vote_n_device

TRUST_NORMAL = 2


def _local_find_centres(P2_local, spSym, codeOffset, *, Nfft, windowWidth, spsymMin,
                        numSymMax, select_route="gather", cols=None,
                        num_masks_local=None):
    """Shard-local half of the windowed symbol argmax.

    Same index math and column-max-first formulation as
    ``ops.demod_kernels.find_centres`` (parity:
    ``cuda_kernels.cu:78-146``; clamped full-window edge semantics, the
    gather-free ``sliding_window_argmax`` tree, (offset, mask)
    lexicographic tie-break) but only over the local mask rows; returns
    (local max value, local (k_win, m_local) pair, geometry) so the
    global argmax can be reduced across the ``dopp`` axis with the same
    (offset, mask) first-win order as the single-chip kernel.

    ``cols``: optional precomputed local ``(Vcol, m_l)`` from the fused
    mask-bank route (``apply_best_doppler_power_cols``), with
    ``num_masks_local``; makes ``P2_local`` unused (pass None).
    """
    from pycusdr_tpu.ops.demod_kernels import sliding_window_argmax

    W = windowWidth
    Wl = W // 2
    N = Nfft

    spc = jnp.maximum(spSym, float(spsymMin))
    x = jnp.arange(numSymMax, dtype=jnp.float32)
    base = x * spc - Wl + codeOffset
    A0 = jnp.trunc(base).astype(jnp.int32)
    comp = jnp.trunc(codeOffset).astype(jnp.int32) - jnp.minimum(A0, 0)
    A = jnp.clip(A0, 0, max(N - W, 0))

    if cols is not None:
        Vcol, m_l = cols
        m_l = m_l.astype(jnp.int32)
        Ml = int(num_masks_local)
    else:
        m_l = jnp.argmax(P2_local, axis=0).astype(jnp.int32)  # lowest local mask
        Vcol = jnp.max(P2_local, axis=0)
        Ml = int(P2_local.shape[0])
    Vt, payload, prod_b = sliding_window_argmax(
        Vcol[None, :], W, (m_l,), extra_bounds=(Ml,), packed=True)

    packed = jnp.stack([Vt[0], payload[0]], axis=1)  # (N+W, 2)
    if select_route == "onehot":
        # bit-exact one-hot row select (see
        # ops.demod_kernels._select_rows_onehot)
        from pycusdr_tpu.ops.demod_kernels import _select_rows_onehot

        R = _select_rows_onehot(packed, A)
    else:
        R = jnp.take(packed, A, axis=0)  # (numSymMax, 2)
    val = R[:, 0]
    pf = R[:, 1].astype(jnp.int32)
    m_sel = pf % jnp.int32(prod_b)
    k_win = (pf // jnp.int32(prod_b) - A).astype(jnp.int32)

    nSym = (Nfft / spc).astype(jnp.int32)
    return val, k_win, m_sel, x, spc, comp, nSym


def _build_channel_parallel_step(spec: DemodSpec, mesh, vote: bool,
                                 master_idx: int, master_weight: float):
    """nd == 1 specialization: vmap the single-chip graph over the
    local channels inside shard_map; the only collective is the
    diversity vote's bits/trust all-gather on the ``channel`` axis."""
    from pycusdr_tpu.dsp.block import build_process_batch

    # chunk-evaluated like the single-chip batch path (BATCH_CHUNK):
    # many local channels hit the same whole-width tiling cliff
    vcore = build_process_batch(spec, jit=False)
    numSymMax = spec.numSymMax
    keys = ("bits", "trust", "symbols", "centres", "mags", "nSym", "nBits",
            "spSym", "doppler_hz", "freq_offset_hz", "quality_db",
            "snr_db", "shift")

    def step(blocks):
        res = vcore(blocks.astype(jnp.float32))
        out = {k: res[k] for k in keys}
        if vote:
            # pad slots beyond each channel's own bit count must not
            # vote (same masking as runtime/channel_group_process.py)
            slot = jnp.arange(numSymMax, dtype=jnp.int32)[None, :]
            tv = jnp.where(slot < res["nBits"][:, None], res["trust"],
                           jnp.int8(-1))
            bits_all = jax.lax.all_gather(res["bits"], "channel", axis=0,
                                          tiled=True)
            trust_all = jax.lax.all_gather(tv, "channel", axis=0, tiled=True)
            voted, vtrust = vote_n_device(bits_all, trust_all, master_idx,
                                          master_weight)
            out["bits_voted"] = voted
            out["trust_voted"] = vtrust
        return out

    ch = P("channel", None)
    out_specs = {
        "bits": ch, "trust": ch, "symbols": ch, "centres": ch, "mags": ch,
        "nSym": P("channel"), "nBits": P("channel"), "spSym": P("channel"),
        "doppler_hz": P("channel"),
        "freq_offset_hz": P("channel"), "quality_db": P("channel"),
        "snr_db": P("channel"), "shift": P("channel"),
    }
    if vote:
        out_specs["bits_voted"] = P()
        out_specs["trust_voted"] = P()

    sharded = shard_map(step, mesh=mesh,
                        in_specs=(P("channel", None, None),),
                        out_specs=out_specs, check_vma=False)
    blocks_sharding = NamedSharding(mesh, P("channel", None, None))

    def run_impl(blocks):
        blocks = jax.lax.with_sharding_constraint(blocks, blocks_sharding)
        # contraction dtype is pinned inside build_process_block via
        # spec.matmul_dtype, so no extra wrapper is needed here
        return sharded(blocks)

    return jax.jit(run_impl)


def build_sharded_demod_step(spec: DemodSpec, mesh, vote: bool = True,
                             master_idx: int = 0, master_weight: float = 1.2,
                             select_route: str = "gather",
                             force_generic: bool = False):
    """Return ``step(blocks) -> dict`` jitted over ``mesh``.

    ``blocks``: (C, 2, Nfft) float32 split complex (see ops/cfft.py),
    channels sharded over the ``channel`` axis (C must divide by
    mesh.shape['channel']).

    Route choices mirror the single-chip graph (dsp/block.py): every
    Doppler grid evaluates the search with the pruned-output DFT
    contraction (``ops.doppler_search.doppler_energy_corr_dft``) — here
    with the mask rows of ``Qf`` sharded over the ``dopp`` mesh axis
    and the phasor matrix ``F`` replicated, so each shard contracts
    (Ml, N) x (N, D) and the cross-shard traffic stays one tiny (D, M)
    all-gather.
    ``select_route``: slot-read evaluation in the local symbol argmax —
    "gather" (default) or "onehot" for A/B measurement.

    The Doppler contraction's operand dtype follows ``spec.matmul_dtype`` (the
    config's ``matmulDtype`` knob), pinned at trace time exactly like
    the single-chip graph, so a bf16 deployment runs the same numerics
    sharded and unsharded.
    """
    nc = mesh.shape["channel"]
    nd = mesh.shape["dopp"]
    N = spec.Nfft
    M = spec.num_masks
    D = spec.D
    W = spec.windowWidth
    if M % nd:
        raise ValueError(f"num_masks={M} must divide by dopp axis size {nd}")
    # centre-bit LUT protocols and NRZ-S (BPSK) transition-LUT
    # protocols are both supported: the global symbols are known after
    # the cross-shard argmax, so bit extraction is shard-local
    Ml = M // nd
    if select_route not in ("gather", "onehot"):
        raise ValueError(f"unknown select_route {select_route!r}")

    if nd == 1 and not force_generic:
        # pure channel parallelism (the common deployment shape): no
        # tensor-parallel split to reconcile, so run the EXACT
        # single-chip graph vmapped over the local channels — same
        # routes, same fusion, bit-identical by construction — and keep
        # only the vote collective. ``force_generic`` keeps the generic program measurable on a
        # 1-device mesh (bench/scaling.py --generic).
        return _build_channel_parallel_step(spec, mesh, vote, master_idx,
                                            master_weight)

    if spec.doppler_search:
        # pruned-output DFT route constants: Qf rows sharded over the
        # mask (= "dopp") axis, inverse-DFT phasor columns replicated
        qf_ri = make_qf_ri(spec.masks_f)          # (M, 2, N)
        corr_F = make_corr_dft_F(N, spec.dopp_shifts)  # (2, N, D)
    else:
        qf_ri = np.zeros((M, 2, 1), np.float32)   # unused placeholder
        corr_F = np.zeros((2, 1, 1), np.float32)

    masks_ri = c2ri(spec.masks_f)  # (M, 2, N) f32
    off_m = spec.code_search_mask_offset
    w_mask = np.zeros(M, np.float32)
    w_mask[off_m : M - off_m] = 1.0

    hz_lut = spec.dopp_hz_lut.astype(np.float32)
    dopp_shifts = spec.dopp_shifts.astype(np.int32)
    bitLUT = None if spec.bitLUT is None else spec.bitLUT.astype(np.int8)
    symLUT = None if spec.symbolLUT is None else spec.symbolLUT.astype(np.int32)
    # clamp: a fractional voteWeight config must not truncate to 0
    trust_normal = np.int8(max(1, int(TRUST_NORMAL * spec.voteWeight)))
    numSymMax = spec.numSymMax

    est = partial(
        find_doppler_estimate,
        num_dopplers=spec.num_dopplers,
        array_offset=spec.dopp_array_offset,
        sum_all_masks=spec.sum_all_masks,
    )

    def step(blocks, masks_l, w_mask_l, qf_l, F_r, hz_r, shifts_r, lut_r):
        # blocks: local (Cl, 2, N); masks_l: (Ml, 2, N);
        # qf_l: (Ml, 2, N); F_r: (2, N, D)
        sig = blocks.astype(jnp.float32)
        if not spec.disable_peak_thresholding:
            sig, clipped = jax.vmap(
                lambda s: threshold_input(s, spec.peak_threshold_scale)
            )(sig)  # clipped: (Cl, N) bool
        else:
            clipped = None
        S = fft_ri(sig)  # (Cl, 2, N)

        if spec.doppler_search:
            Pw = S[:, 0] ** 2 + S[:, 1] ** 2  # (Cl, N)
            # pruned-output DFT contraction, mask rows local: each
            # shard redoes the cheap real-input FFT of P (one
            # transform) and contracts only its Ml masks against
            # the replicated (N, D) phasor columns
            E_local = jax.vmap(
                lambda p: doppler_energy_corr_dft(p, qf_l, F_r)
            )(Pw)  # (Cl, D, Ml)
            E = jax.lax.all_gather(E_local, "dopp", axis=2, tiled=True)
            dopp_idx, quality_db = jax.vmap(est)(E)

            lowIdx = jnp.clip(jnp.floor(dopp_idx).astype(jnp.int32), 0, D - 1)
            highIdx = jnp.clip(jnp.ceil(dopp_idx).astype(jnp.int32), 0, D - 1)
            frac = jnp.mod(dopp_idx, 1.0)
            doppler_hz = hz_r[lowIdx] + (hz_r[highIdx] - hz_r[lowIdx]) * frac
            # unwrap before interpolating (see dsp/block.py: grids that
            # straddle DC must not interpolate across the N-1 -> 0 seam)
            sh_signed = jnp.mod(shifts_r + N // 2, N) - N // 2
            sl = sh_signed[lowIdx].astype(jnp.float32)
            sh = sh_signed[highIdx].astype(jnp.float32)
            shift = jnp.mod(jnp.round(sl + (sh - sl) * frac).astype(jnp.int32), N)  # (Cl,)
            absS = jnp.sqrt(Pw)
            snr_db = jax.vmap(
                lambda a, lo, hi: compute_snr(a, lo, hi, spec.snr_window, N)
            )(absS, shifts_r[lowIdx], shifts_r[highIdx])
            freq_offset_hz = doppler_hz - spec.centreFreqOffset
        else:
            Cl = blocks.shape[0]
            shift = jnp.full((Cl,), spec.dopp_offset_idx, jnp.int32)
            doppler_hz = jnp.zeros((Cl,), jnp.float32)
            freq_offset_hz = jnp.zeros((Cl,), jnp.float32)
            quality_db = jnp.zeros((Cl,), jnp.float32)
            snr_db = jnp.zeros((Cl,), jnp.float32)

        # --- demod with the mask bank sharded over "dopp" ---
        if off_m == 0:
            # fused mask-axis reductions (same as the single-chip fused
            # bank route): the three consumers of the local (Cl, Ml, N)
            # power (timing sum, detection max/argmax) come straight
            # from the transform.
            # Gated on CODE_SEARCH_MASK_OFFSET == 0 because the fused
            # subset sum needs static LOCAL bounds and a nonzero offset
            # intersects the shard range at a runtime shard index.
            from pycusdr_tpu.ops.demod_kernels import (
                apply_best_doppler_power_cols,
            )

            colsum_l, Vcol_l, m_col_l = jax.vmap(
                lambda s, sh_: apply_best_doppler_power_cols(
                    s, masks_l, sh_, 0, Ml)
            )(S, shift)  # each (Cl, N)
            P2 = None
            power = jax.lax.psum(colsum_l, "dopp")  # (Cl, N), all masks
        else:
            P2 = jax.vmap(
                lambda s, sh_: apply_best_doppler_power(s, masks_l, sh_)
            )(S, shift)  # (Cl, Ml, N)

            # HIGHEST: a 0/1 mask-weight sum must stay true f32 (the GPU
            # would otherwise be free to run it in TF32)
            power = jax.lax.psum(
                jnp.einsum("m,cmn->cn", w_mask_l, P2,
                           precision=jax.lax.Precision.HIGHEST), "dopp"
            )  # (Cl, N) summed matched-filter power, mask subset

        # output-pruned band DFT (see ops.cfft.band_dft_real): only the
        # searched timing bins are computed
        R = band_dft_real(power, spec.code_idx_lo, spec.code_idx_hi)
        br = R[:, 0]
        bi = R[:, 1]
        band_pow = br * br + bi * bi
        k_rel = jnp.argmax(band_pow, axis=1)
        pr = jnp.take_along_axis(br, k_rel[:, None], axis=1)[:, 0]
        pi = jnp.take_along_axis(bi, k_rel[:, None], axis=1)[:, 0]
        phase = jnp.arctan2(pi, pr)
        kf = (spec.code_idx_lo + k_rel).astype(jnp.float32)
        spSym = N / kf
        codeOffset = -phase / jnp.pi * spSym / 2
        codeOffset = jnp.where(codeOffset < 0, codeOffset + spSym - 1, codeOffset)

        if P2 is None:
            val_l, k_l, m_l, x, spc, comp, nSym = jax.vmap(
                lambda vc, mc, ss, co: _local_find_centres(
                    None, ss, co, Nfft=N, windowWidth=W,
                    spsymMin=spec.spsymMin, numSymMax=numSymMax,
                    select_route=select_route, cols=(vc, mc),
                    num_masks_local=Ml,
                )
            )(Vcol_l, m_col_l, spSym, codeOffset)
        else:
            val_l, k_l, m_l, x, spc, comp, nSym = jax.vmap(
                lambda p2, ss, co: _local_find_centres(
                    p2, ss, co, Nfft=N, windowWidth=W,
                    spsymMin=spec.spsymMin, numSymMax=numSymMax,
                    select_route=select_route,
                )
            )(P2, spSym, codeOffset)

        # global (offset, mask)-lexicographic argmax across the dopp
        # shards, matching ops.demod_kernels.find_centres: flat key
        # k*M + global_mask, min over equal-valued candidates
        d_id = jax.lax.axis_index("dopp")
        g_idx = k_l * M + (d_id * Ml + m_l)  # (Cl, numSymMax)
        vals = jax.lax.all_gather(val_l, "dopp", axis=0, tiled=False)  # (nd, Cl, nSymMax)
        gidx = jax.lax.all_gather(g_idx, "dopp", axis=0, tiled=False)
        best_val = jnp.max(vals, axis=0)
        big = jnp.int32(M * W + M + 1)
        g = jnp.min(jnp.where(vals == best_val, gidx, big), axis=0)
        symbols = (g % M).astype(jnp.int32)
        maxK = (g // M).astype(jnp.int32)
        centres = (
            jnp.trunc(x * spc[:, None] - (W // 2) + maxK.astype(jnp.float32)).astype(jnp.int32)
            + comp
        )

        slot = jnp.arange(numSymMax, dtype=jnp.int32)[None, :]
        trust = jnp.where(slot < nSym[:, None], trust_normal, jnp.int8(-1))
        if bitLUT is not None:
            bits = jnp.take(lut_r, symbols, axis=0).astype(jnp.int8)
            nBits = nSym
        else:
            from pycusdr_tpu.ops.demod_kernels import extract_bits_nrzs

            bits, err = jax.vmap(
                lambda sy: extract_bits_nrzs(sy, lut_r)
            )(symbols)
            trust = jnp.where(err, jnp.int8(-1), trust)
            nBits = nSym - 1

        if clipped is not None:
            # trust -2 within ±2·spSym of clipped interference, matching
            # the single-chip path (dsp/block.py / reference
            # demodulator_base.py:818-837) — sampled at the winning
            # SAMPLE like ops.demod_kernels.find_centres(clip_mask=...)
            from pycusdr_tpu.ops.demod_kernels import dilate_mask_dynamic

            Wl_ = W // 2
            A0 = jnp.trunc(
                x * spc[:, None] - Wl_ + codeOffset[:, None]
            ).astype(jnp.int32)
            A_cl = jnp.clip(A0, 0, max(N - W, 0))
            win_abs = A_cl + maxK
            hw = 2 * jnp.ceil(spc).astype(jnp.int32)  # (Cl,)
            at_win = jax.vmap(
                lambda cl, h, wa: jnp.take(
                    dilate_mask_dynamic(cl, h), jnp.clip(wa, 0, N - 1)
                )
            )(clipped, hw, win_abs)
            trust = jnp.where(at_win, jnp.int8(-2), trust)

        out = {
            "bits": bits,
            "trust": trust,
            "symbols": symbols,
            "centres": centres,
            "mags": best_val,
            "nSym": nSym,
            "nBits": nBits,
            "spSym": spSym,
            "doppler_hz": doppler_hz,
            "freq_offset_hz": freq_offset_hz,
            "quality_db": quality_db,
            "snr_db": snr_db,
            "shift": shift,
        }

        if vote:
            bits_all = jax.lax.all_gather(bits, "channel", axis=0, tiled=True)
            trust_all = jax.lax.all_gather(trust, "channel", axis=0, tiled=True)
            voted, vtrust = vote_n_device(bits_all, trust_all, master_idx, master_weight)
            out["bits_voted"] = voted
            out["trust_voted"] = vtrust
        return out

    ch = P("channel", None)
    rep = P()
    out_specs = {
        "bits": ch, "trust": ch, "symbols": ch, "centres": ch, "mags": ch,
        "nSym": P("channel"), "nBits": P("channel"), "spSym": P("channel"),
        "doppler_hz": P("channel"),
        "freq_offset_hz": P("channel"), "quality_db": P("channel"),
        "snr_db": P("channel"), "shift": P("channel"),
    }
    if vote:
        out_specs["bits_voted"] = rep
        out_specs["trust_voted"] = rep

    sharded = shard_map(
        step,
        mesh=mesh,
        in_specs=(
            P("channel", None, None),   # blocks
            P("dopp", None, None),      # mask bank
            P("dopp"),                  # mask weight vector
            P("dopp", None, None),      # Qf power-mask spectra
            P(None, None, None),        # inverse-DFT phasor columns F
            P(None),              # hz lut
            P(None),              # doppler shifts
            # bit LUT (1-D) or NRZ-S symbol LUT (3-D), replicated
            P(None) if bitLUT is not None else P(None, None, None),
        ),
        out_specs=out_specs,
        check_vma=False,
    )

    dev_consts = (
        jnp.asarray(masks_ri),
        jnp.asarray(w_mask),
        jnp.asarray(qf_ri),
        jnp.asarray(corr_F),
        jnp.asarray(hz_lut),
        jnp.asarray(dopp_shifts),
        jnp.asarray(bitLUT if bitLUT is not None else symLUT),
    )
    blocks_sharding = NamedSharding(mesh, P("channel", None, None))

    def run_impl(blocks):
        blocks = jax.lax.with_sharding_constraint(blocks, blocks_sharding)
        if spec.matmul_dtype is not None:
            # pin the contraction operand dtype at TRACE time, same as
            # dsp.block.build_process_block — sharded and single-chip
            # deployments of one config must run the same numerics
            from pycusdr_tpu.ops.doppler_search import matmul_dtype

            with matmul_dtype(spec.matmul_dtype):
                return sharded(blocks, *dev_consts)
        return sharded(blocks, *dev_consts)

    return jax.jit(run_impl)
