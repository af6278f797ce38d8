"""The jitted per-block demodulation graph.

Composes the ops in ``pycusdr_tpu.ops`` into ONE XLA computation per
block: clip → FFT → Doppler search (one contraction) → best-shift matched
filter → symbol timing → symbol detection → bits + trust. The reference
needs 6 kernel launches, 3 cuFFT plans and 4 device→host syncs per
block (SURVEY §3.2); here there is exactly one device→host transfer of
the small result bundle.

Signals travel between stages as split ``[re, im]`` float32 (see
``ops.cfft``; the FFT wrappers convert to complex internally). The
public entry takes a ``(2, Nfft)`` float32 block; use ``cfft.c2ri`` at
the host boundary.

Golden-tested against ``dsp.reference.demod_block_numpy``.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pycusdr_tpu.dsp.spec import DemodSpec
from pycusdr_tpu.ops.cfft import c2ri, fft_ri
from pycusdr_tpu.ops.demod_kernels import (
    apply_best_doppler_power,
    apply_best_doppler_power_cols,
    compute_snr,
    dilate_mask_dynamic,
    extract_bits_lut,
    extract_bits_nrzs,
    find_centres,
    find_code_rate_and_phase,
    find_code_rate_and_phase_from_power,
    threshold_input,
)
from pycusdr_tpu.ops.doppler_search import (
    doppler_energy_corr,
    doppler_energy_corr_dft,
    doppler_energy_matmul,
    find_doppler_estimate,
    make_corr_dft_F,
    make_qf_ri,
    make_shift_gather_indices,
)

# Grid size from which the tests exercise the correlation routes
# (corr_dft is the default at every D; the "matmul" route materializes
# the (D, N) shifted spectrum with a gather and is kept for A/B only).
CORR_ROUTE_MIN_D = 32

TRUST_NORMAL = 2
TRUST_SYMBOL_ERROR = -1
TRUST_CLIPPED = -2


#: scalar outputs in pack order (see pack_block_outputs)
PACK_SCALARS = ("nSym", "nBits", "spSym", "codeOffset", "code_val",
                "dopp_idx", "quality_db", "doppler_hz", "freq_offset_hz",
                "snr_db", "shift", "clipped_any")


def packed_len(spec: DemodSpec) -> int:
    return 5 * spec.numSymMax + len(PACK_SCALARS) + spec.D * spec.num_masks


def pack_block_outputs(out: dict, spec: DemodSpec):
    """Flatten a block-graph result dict into ONE f32 vector (device op).

    The result dict has ~17 leaves; fetching each costs one
    device->host transfer. Packing makes the device->host path ONE
    ~92 KB transfer per block.
    All integer payloads (bits, symbols, centres, counts, shift) are
    < 2^24 so the f32 round trip is exact; float payloads are f32
    already (pass-through, -inf SNR included).
    """
    parts = [out[k].astype(jnp.float32)
             for k in ("bits", "trust", "symbols", "centres", "mags")]
    # leading batch axes supported: scalars become (..., n), E flattens
    # its trailing (D, M) only
    parts.append(jnp.stack([out[k].astype(jnp.float32)
                            for k in PACK_SCALARS], axis=-1))
    E = out["E"].astype(jnp.float32)
    parts.append(E.reshape(E.shape[:-2] + (-1,)))
    return jnp.concatenate(parts, axis=-1)


def unpack_block_outputs(vec: np.ndarray, spec: DemodSpec) -> dict:
    """Host-side inverse of ``pack_block_outputs`` (numpy, zero-copy
    views where dtypes allow)."""
    v = np.asarray(vec)
    S = spec.numSymMax
    out = {
        "bits": v[0:S].astype(np.int8),
        "trust": v[S:2 * S].astype(np.int8),
        "symbols": v[2 * S:3 * S].astype(np.int32),
        "centres": v[3 * S:4 * S].astype(np.int32),
        "mags": v[4 * S:5 * S],
    }
    sc = v[5 * S:5 * S + len(PACK_SCALARS)]
    for i, k in enumerate(PACK_SCALARS):
        out[k] = sc[i]
    for k in ("nSym", "nBits", "shift"):
        out[k] = np.int32(out[k])
    out["clipped_any"] = bool(out["clipped_any"])
    out["E"] = v[5 * S + len(PACK_SCALARS):].reshape(spec.D, spec.num_masks)
    return out


def build_process_block(spec: DemodSpec, jit: bool = True, donate: bool = False,
                        latency_mode: bool = False, dopp_route: str = None,
                        centres_route: str = None, fft_dtype: str = None,
                        packed: bool = False, select_route: str = None,
                        bank_route: str = None, gather_pad: int = None):
    """Return ``process_block(samples_ri) -> dict`` jitted for ``spec``.

    ``samples_ri``: (2, Nfft) float32 split complex block. All
    spec-derived constants are closed over as numpy (embedded by XLA).

    ``latency_mode``: build the graph for SINGLE-block dispatch. Both
    modes take the gather slot read; the flag is kept only for API
    stability / measurement labelling. ``select_route`` overrides for
    A/B.

    ``dopp_route``: override the Doppler evaluation — "corr_dft"
    (pruned-output DFT contraction, the default at every grid size) or
    "corr" (all-N-lags FFT correlation + column gather; smaller
    constant footprint, for benchmarking route choices) or "matmul"
    (shifted-spectrum gather + one matmul; for A/B only).

    ``centres_route``: override the symbol-detection window scan —
    "window" (sliding-window tree at all positions) or "blockscan"
    (slot-pruned van Herk with deferred combine); None takes
    ``ops.demod_kernels.CENTRES_SCAN_ROUTE``. Bit-identical routes,
    chosen by measurement.

    ``fft_dtype``: operand dtype for the Doppler-search contraction —
    None (= ``spec.matmul_dtype``, i.e. the config's ``matmulDtype``
    knob, falling back to ``ops.doppler_search.MATMUL_DTYPE``, default
    f32) or "bfloat16" (f32 accumulation; BER-delta-gated, see
    ops/doppler_search.py). Pinned at trace time, so the returned graph
    carries the choice regardless of the global's later value.

    ``bank_route``: "fused" (default) computes the matched-filter
    bank's mask-axis reductions (timing sum, detection max/argmax)
    straight from the inverse transform, in one fused pass over the
    (M, N) power; "p2" returns the power tensor first (kept for A/B and
    the sharded tensor-split program). Bit-identical (exactness-tested).

    ``packed``: return ONE flat f32 vector instead of the result dict
    (``pack_block_outputs`` layout; decode with
    ``unpack_block_outputs``). The streaming runtime uses this so each
    block costs exactly one device->host round trip.
    """
    if fft_dtype is None:
        fft_dtype = spec.matmul_dtype
    if select_route is None:
        select_route = "gather"
    elif select_route not in ("gather", "onehot", "grouped"):
        raise ValueError(f"unknown select_route {select_route!r}")
    if centres_route not in (None, "window", "blockscan"):
        raise ValueError(f"unknown centres_route {centres_route!r}")
    # static slot-stride bound for the grouped patch-gather route: the
    # timing band guarantees spSym <= Nfft / code_idx_lo
    sp_max = float(spec.Nfft) / max(spec.code_idx_lo, 1)
    if dopp_route is None:
        dopp_route = "corr_dft"
    elif dopp_route not in ("corr_dft", "corr", "matmul"):
        raise ValueError(f"unknown dopp_route {dopp_route!r}")
    if bank_route is None:
        bank_route = "fused"
    elif bank_route not in ("fused", "p2"):
        raise ValueError(f"unknown bank_route {bank_route!r}")
    corr_routes = dopp_route in ("corr_dft", "corr")
    N = spec.Nfft
    masks_ri = c2ri(spec.masks_f)  # (M, 2, N) f32
    Q_T = ((np.abs(spec.masks_f.astype(np.complex64)) ** 2).T.astype(np.float32)
           if dopp_route == "matmul" else None)  # (N, M)
    shift_idx = (make_shift_gather_indices(N, spec.dopp_shifts)
                 if dopp_route == "matmul" else None)
    qf_ri = make_qf_ri(spec.masks_f) if corr_routes else None
    corr_F = (make_corr_dft_F(N, spec.dopp_shifts)
              if dopp_route == "corr_dft" else None)
    dopp_shifts = spec.dopp_shifts.astype(np.int32)
    hz_lut = spec.dopp_hz_lut.astype(np.float32)
    D = spec.D

    bitLUT = None if spec.bitLUT is None else spec.bitLUT.astype(np.int8)
    symLUT = None if spec.symbolLUT is None else spec.symbolLUT.astype(np.int32)
    # clamp: a fractional voteWeight config must not truncate to 0
    trust_normal = np.int8(max(1, int(TRUST_NORMAL * spec.voteWeight)))

    def process_block(samples_ri: jnp.ndarray, centre_shift=np.int32(0)) -> dict:
        """``centre_shift`` recentres the whole Doppler grid by that many
        FFT bins at runtime (tracking mode: a narrow grid follows the
        estimate of previous blocks instead of sweeping the full
        acquisition range — see models/tracking.py)."""
        sig = samples_ri.astype(jnp.float32)
        # a compile-time-zero recentre (every non-tracking graph) skips
        # the corr route's runtime phasor entirely
        static_zero_centre = (
            not isinstance(centre_shift, jax.core.Tracer)
            and int(np.asarray(centre_shift)) == 0
        )
        centre_shift = jnp.asarray(centre_shift, jnp.int32)

        if spec.disable_peak_thresholding:
            clipped = jnp.zeros((N,), dtype=bool)
        else:
            sig, clipped = threshold_input(sig, spec.peak_threshold_scale)

        S = fft_ri(sig)  # (2, N)
        P = S[0] ** 2 + S[1] ** 2  # power spectrum

        if spec.doppler_search:
            absS = jnp.sqrt(P)
            if dopp_route == "corr_dft":
                E = doppler_energy_corr_dft(
                    P, jnp.asarray(qf_ri), jnp.asarray(corr_F),
                    None if static_zero_centre else centre_shift)
            elif dopp_route == "corr":
                E = doppler_energy_corr(P, jnp.asarray(qf_ri),
                                        jnp.asarray(dopp_shifts), centre_shift)
            elif static_zero_centre:
                E = doppler_energy_matmul(P, Q_T, shift_idx)
            else:
                # matmul route with a runtime recentre: rotate the
                # spectrum so the static gather probes (k + s_d + centre)
                Pc = jax.lax.dynamic_slice_in_dim(
                    jnp.concatenate([P, P]), jnp.mod(centre_shift, N), N
                )
                E = doppler_energy_matmul(Pc, Q_T, shift_idx)
            dopp_idx, quality_db = find_doppler_estimate(
                E, spec.num_dopplers, spec.dopp_array_offset, spec.sum_all_masks
            )
            # fractional-bin interpolation (reference demodulator_base.py:609-618)
            lowIdx = jnp.clip(jnp.floor(dopp_idx).astype(jnp.int32), 0, D - 1)
            highIdx = jnp.clip(jnp.ceil(dopp_idx).astype(jnp.int32), 0, D - 1)
            frac = jnp.mod(dopp_idx, 1.0)
            hz = jnp.asarray(hz_lut)
            sh_t = jnp.asarray(dopp_shifts)
            centre_hz = centre_shift.astype(jnp.float32) * (spec.sampleRate / N)
            doppler_hz = hz[lowIdx] + (hz[highIdx] - hz[lowIdx]) * frac + centre_hz
            # interpolate on UNWRAPPED shifts: a grid straddling DC has
            # neighbours ~N-1 and 0, and naive interpolation would land
            # near N/2 (latent in the reference, demodulator_base.py:609)
            sh_signed = jnp.mod(sh_t + N // 2, N) - N // 2
            sl = sh_signed[lowIdx].astype(jnp.float32)
            sh = sh_signed[highIdx].astype(jnp.float32)
            shift = jnp.mod(
                jnp.round(sl + (sh - sl) * frac).astype(jnp.int32) + centre_shift, N
            )
            snr_db = compute_snr(absS, sh_t[lowIdx] + centre_shift,
                                 sh_t[highIdx] + centre_shift, spec.snr_window, N)
            freq_offset_hz = doppler_hz - spec.centreFreqOffset
        else:
            E = jnp.zeros((D, spec.num_masks), dtype=jnp.float32)
            dopp_idx = jnp.float32(0.0)
            quality_db = jnp.float32(0.0)
            doppler_hz = jnp.float32(0.0)
            freq_offset_hz = jnp.float32(0.0)
            snr_db = jnp.float32(0.0)
            shift = jnp.int32(spec.dopp_offset_idx)

        M = spec.num_masks
        off = spec.code_search_mask_offset
        if bank_route == "fused":
            # mask-axis reductions taken straight from the inverse
            # transform (bit-identical to the p2 route)
            colsum, Vcol, m_star = apply_best_doppler_power_cols(
                S, jnp.asarray(masks_ri), shift, off, M - off)
            P2 = None
            cols = (Vcol, m_star)
            spSym, codeOffset, code_val = find_code_rate_and_phase_from_power(
                colsum, spec.code_idx_lo, spec.code_idx_hi, N)
        else:
            P2 = apply_best_doppler_power(S, jnp.asarray(masks_ri), shift)  # (M, N)
            cols = None
            spSym, codeOffset, code_val = find_code_rate_and_phase(
                P2, spec.code_idx_lo, spec.code_idx_hi, N, off
            )

        # the dilated interference mask rides the symbol-selection tree
        # (sampled at each slot's winning sample) instead of a per-slot
        # gather afterwards
        if not spec.disable_peak_thresholding:
            spc_pre = jnp.maximum(spSym, float(spec.spsymMin))
            hw = 2 * jnp.ceil(spc_pre).astype(jnp.int32)
            clip_dil = dilate_mask_dynamic(clipped, hw)
            symbols, centres, mags, nSym, spc, at_win = find_centres(
                P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
                spsymMin=spec.spsymMin, numSymMax=spec.numSymMax,
                clip_mask=clip_dil, select_route=select_route,
                scan_route=centres_route, sp_max=sp_max,
                cols=cols, num_masks=M, gather_pad=gather_pad,
            )
        else:
            symbols, centres, mags, nSym, spc = find_centres(
                P2, spSym, codeOffset, Nfft=N, windowWidth=spec.windowWidth,
                spsymMin=spec.spsymMin, numSymMax=spec.numSymMax,
                select_route=select_route, scan_route=centres_route,
                sp_max=sp_max, cols=cols, num_masks=M, gather_pad=gather_pad,
            )

        trust = jnp.full((spec.numSymMax,), trust_normal, dtype=jnp.int8)
        if bitLUT is not None:
            bits = extract_bits_lut(symbols, jnp.asarray(bitLUT))
            nBits = nSym
        else:
            bits, err = extract_bits_nrzs(symbols, jnp.asarray(symLUT))
            trust = jnp.where(err, jnp.int8(TRUST_SYMBOL_ERROR), trust)
            nBits = nSym - 1

        # tag bits near clipped interference with trust -2
        # (reference demodulator_base.py:818-837; at_win sampled by the
        # selection tree above)
        if not spec.disable_peak_thresholding:
            trust = jnp.where(at_win, jnp.int8(TRUST_CLIPPED), trust)

        return {
            "bits": bits,
            "trust": trust,
            "symbols": symbols,
            "centres": centres,
            "mags": mags,
            "nSym": nSym,
            "nBits": nBits,
            "spSym": spSym,
            "codeOffset": codeOffset,
            "code_val": code_val,
            "dopp_idx": dopp_idx,
            "quality_db": quality_db,
            "doppler_hz": doppler_hz,
            "freq_offset_hz": freq_offset_hz,
            "snr_db": snr_db,
            "shift": shift,
            "clipped_any": jnp.any(clipped),
            "E": E,
        }

    if fft_dtype is not None:
        from pycusdr_tpu.ops.doppler_search import matmul_dtype

        inner = process_block

        def process_block(samples_ri, centre_shift=np.int32(0)):
            # entered during TRACING (the body runs under jit/vmap), so
            # the dtype choice is baked into this graph specifically
            with matmul_dtype(fft_dtype):
                return inner(samples_ri, centre_shift)

    if packed:
        inner_dict = process_block

        def process_block(samples_ri, centre_shift=np.int32(0)):
            return pack_block_outputs(inner_dict(samples_ri, centre_shift),
                                      spec)

    if jit:
        kwargs = {"donate_argnums": (0,)} if donate else {}
        return jax.jit(process_block, **kwargs)
    return process_block


#: vmap width of one sub-batch: batches larger than this are evaluated
#: as unrolled chunks of this width INSIDE one jit (bit-identical to the
#: whole vmap). The value was tuned on the system's first accelerator;
#: it has not been re-derived for the GPU.
BATCH_CHUNK = 16


def build_process_batch(spec: DemodSpec, jit: bool = True,
                        chunk: int = BATCH_CHUNK, **kw):
    """Return ``batched(blocks_ri) -> outputs`` for (B, 2, Nfft) inputs.

    vmaps the block graph, evaluating batches larger than ``chunk`` as
    sequential chunk-wide sub-batches inside the same jit (see
    BATCH_CHUNK). Extra kwargs pass through to ``build_process_block``
    (``packed=True`` gives a (B, L) result). Batches that are not a
    multiple of ``chunk`` fall back to one whole vmap.
    """
    core = build_process_block(spec, jit=False, **kw)
    vc = jax.vmap(core)
    # the chunk-evaluated form uses the 8-col padded slot-gather
    # source (the whole-vmap form 2 — see
    # ops.demod_kernels.GATHER_PAD_COLS). Identical values read, so
    # mixing the two shapes stays bit-identical. Built
    # LAZILY: most callers (streaming with maxBatchBlocks <= chunk)
    # never take the chunked branch, and eagerly constructing a second
    # graph would re-derive every embedded constant (masks, Qf, the
    # (2, N, D) corr-DFT phasors) in the warmup window for nothing.
    _chunk_cell = [vc] if "gather_pad" in kw else []

    def vc_chunk(blocks):
        if not _chunk_cell:
            _chunk_cell.append(jax.vmap(build_process_block(
                spec, jit=False, gather_pad=8, **kw)))
        return _chunk_cell[0](blocks)

    def batched(blocks):
        B = blocks.shape[0]
        if chunk and B > chunk and B % chunk == 0:
            outs = [vc_chunk(blocks[i * chunk:(i + 1) * chunk])
                    for i in range(B // chunk)]
            return jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0),
                                *outs)
        return vc(blocks)

    return jax.jit(batched) if jit else batched


def build_process_stream(spec: DemodSpec, jit: bool = True):
    """Whole-capture processor: ``stream(hops_ri, carry_ri) -> (res, carry)``.

    ``hops_ri``: (K, 2, hop) split-complex new samples; ``carry_ri``:
    (2, sigOverlap) tail from the previous call. One ``lax.scan`` walks
    the overlap-save chain entirely on device — a single dispatch
    demodulates an arbitrary capture.

    SUPERSEDED for offline reprocessing by ``build_process_capture``:
    overlap-save block k's input is a pure slice of the capture, so the
    blocks need not be walked in sequence — kept for A/B and as the
    constant-memory route (the capture processor materializes K
    overlapped blocks).
    """
    # each scan step demodulates ONE block, so the latency-mode select wins
    core = build_process_block(spec, jit=False, latency_mode=True)
    ov = spec.sigOverlap

    def step(carry, hop_ri):
        block = jnp.concatenate([carry, hop_ri], axis=-1)  # (2, Nfft)
        res = core(block)
        res.pop("E")
        return block[:, -ov:], res

    def stream(hops_ri, carry_ri):
        carry, res = jax.lax.scan(step, carry_ri, hops_ri)
        return res, carry

    return jax.jit(stream) if jit else stream


def build_process_capture(spec: DemodSpec, jit: bool = True,
                          chunk: int = BATCH_CHUNK, **kw):
    """Whole-capture processor at BATCH throughput:
    ``capture(hops_ri, carry_ri) -> (res, carry)``, same signature and
    result structure as ``build_process_stream``.

    Overlap-save block k's input is a pure slice of the capture
    (``capture[k·hop : k·hop + Nfft]``) — only the bit HEALER is
    sequential, and it lives on the host — so the blocks are framed
    device-side with K static strided slices and evaluated through the
    chunk-evaluated vmapped batch path (``BATCH_CHUNK``-wide sub-
    batches inside one jit) instead of a sequential ``lax.scan``, so
    offline pass reprocessing runs at the batch rate. Every DECISION
    output (bits, trust, symbols, centres, mags,
    counts, carry) is bit-identical to the scan route; analog scalars
    (codeOffset etc.) may differ by last-ulp accumulation order since
    the vmapped contractions tile differently (tests/test_batching.py).
    """
    core = build_process_block(spec, jit=False, latency_mode=True, **kw)
    vc = jax.vmap(core)
    ov = spec.sigOverlap
    N = spec.Nfft

    def capture(hops_ri, carry_ri):
        K, _, hop = hops_ri.shape
        full = jnp.concatenate(
            [carry_ri, jnp.moveaxis(hops_ri, 0, 1).reshape(2, K * hop)],
            axis=-1)  # (2, ov + K*hop)
        blocks = jnp.stack([full[:, k * hop : k * hop + N]
                            for k in range(K)])  # (K, 2, Nfft)
        if chunk and K > chunk and K % chunk == 0:
            outs = [vc(blocks[i * chunk:(i + 1) * chunk])
                    for i in range(K // chunk)]
            res = jax.tree.map(lambda *xs: jnp.concatenate(xs, axis=0), *outs)
        else:
            res = vc(blocks)
        res.pop("E")
        return res, full[:, -ov:]

    return jax.jit(capture) if jit else capture
