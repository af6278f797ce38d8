"""Demodulation-stage device ops: best-Doppler matched filtering, symbol
timing recovery, windowed symbol detection, bit extraction, spike
clipping and SNR.

Each op mirrors one stage of the reference hot path (citations inline)
but is written as pure, statically-shaped jnp so the whole block chain
fuses into a single XLA graph with one host transfer per block.

Complex tensors are carried split as a length-2 ``[re, im]`` axis of
float32 (see ``ops.cfft``).
"""

import jax
import jax.numpy as jnp
import numpy as np

from pycusdr_tpu.ops.cfft import (
    band_dft_real,
    cmul,
    ifft_unnorm_power_colreduce_ri,
    ifft_unnorm_power_ri,
    ifft_unnorm_ri,
)


def threshold_input(sig_ri: jnp.ndarray, scale: float):
    """Two-pass interference spike clipping
    (reference demodulator_base.py:670-708, host-side there; device here).

    sig_ri: (2, N) split complex. Returns (clipped signal, bool mask of
    samples clipped in pass 2).
    """
    absS = jnp.sqrt(sig_ri[0] ** 2 + sig_ri[1] ** 2)
    thr = scale * jnp.mean(absS)
    hit1 = absS > thr
    safe = jnp.where(hit1, absS, 1.0)
    g1 = jnp.where(hit1, thr / safe, 1.0)
    sig1 = sig_ri * g1[None, :]
    abs1 = jnp.where(hit1, thr, absS)

    thr2 = scale * jnp.mean(abs1)
    hit2 = abs1 > thr2
    safe2 = jnp.where(hit2, abs1, 1.0)
    g2 = jnp.where(hit2, thr2 / safe2, 1.0)
    return sig1 * g2[None, :], hit2


def apply_best_doppler(S_ri: jnp.ndarray, masks_ri: jnp.ndarray, shift) -> jnp.ndarray:
    """Lag-domain matched-filter bank at the winning Doppler shift.

    X[m] = IFFT_unnorm(S[(k+shift) mod N] * masks_f[m]) — parity with
    ``multInputVectorWithShiftedMask`` + batched cuFFT inverse
    (cuda_kernels.cu:174-185, demodulator_base.py:776-785).

    S_ri: (2, N); masks_ri: (M, 2, N). Returns (M, 2, N).
    """
    Ss = _roll_spectrum(S_ri, shift)
    pr, pi = cmul(Ss[0][None, :], Ss[1][None, :], masks_ri[:, 0], masks_ri[:, 1])
    return ifft_unnorm_ri(jnp.stack([pr, pi], axis=-2))


def _roll_spectrum(S_ri: jnp.ndarray, shift) -> jnp.ndarray:
    """S[(k + shift) mod N] for a TRACED shift without a gather: double
    the spectrum and take one contiguous dynamic slice instead of a
    full-N dynamic gather."""
    N = S_ri.shape[-1]
    S2 = jnp.concatenate([S_ri, S_ri], axis=-1)  # (2, 2N)
    start = jnp.mod(jnp.asarray(shift, jnp.int32), N)
    return jax.lax.dynamic_slice_in_dim(S2, start, N, axis=-1)


def apply_best_doppler_power(S_ri: jnp.ndarray, masks_ri: jnp.ndarray, shift) -> jnp.ndarray:
    """|matched filter bank|² directly: same as ``apply_best_doppler``
    followed by re²+im², but the magnitude is fused into the inverse
    transform's final stage (``cfft.ifft_unnorm_power_ri``) so the
    (M, 2, N) complex lag tensor never exists. The whole demod stage
    only ever consumes the power (abs² symbol metric)."""
    Ss = _roll_spectrum(S_ri, shift)
    pr, pi = cmul(Ss[0][None, :], Ss[1][None, :], masks_ri[:, 0], masks_ri[:, 1])
    return ifft_unnorm_power_ri(jnp.stack([pr, pi], axis=-2))


def apply_best_doppler_power_cols(S_ri: jnp.ndarray, masks_ri: jnp.ndarray, shift,
                                  sum_lo: int, sum_hi: int):
    """Mask-axis-reduced matched-filter power at the winning Doppler:
    ``apply_best_doppler_power`` followed by the three reductions its
    only consumers perform — sum over the [sum_lo, sum_hi) mask subset
    (symbol timing, cuda_kernels.cu:191-205) and max/argmax over all
    masks with lowest-mask tie-break (symbol detection,
    cuda_kernels.cu:78-146) — taken in one fused pass over the inverse
    transform's power (see ``cfft.ifft_unnorm_power_colreduce_ri``). Bit-identical to reducing
    the two-step route's P2 (exactness-tested).

    Returns (colsum (N,), colmax (N,), colargmax (N,) i32).
    """
    Ss = _roll_spectrum(S_ri, shift)
    pr, pi = cmul(Ss[0][None, :], Ss[1][None, :], masks_ri[:, 0], masks_ri[:, 1])
    return ifft_unnorm_power_colreduce_ri(
        jnp.stack([pr, pi], axis=-2), sum_lo, sum_hi)


def find_code_rate_and_phase_from_power(power: jnp.ndarray, idx_lo: int,
                                        idx_hi: int, Nfft: int):
    """``find_code_rate_and_phase`` starting from the already
    mask-summed power waveform (the fused mask-bank route's shape)."""
    # output-pruned band DFT: only the searched bins are ever computed
    # (the full rfft spectrum is consumed nowhere else)
    R = band_dft_real(power, idx_lo, idx_hi)  # (2, idx_hi-idx_lo)
    br = R[0]
    bi = R[1]
    band_pow = br * br + bi * bi
    k_rel = jnp.argmax(band_pow)
    val = band_pow[k_rel]
    phase = jnp.arctan2(bi[k_rel], br[k_rel])

    k = (idx_lo + k_rel).astype(jnp.float32)
    spSym = Nfft / k
    codeOffset = -phase / jnp.pi * spSym / 2
    codeOffset = jnp.where(codeOffset < 0, codeOffset + spSym - 1, codeOffset)
    return spSym, codeOffset, val


def find_code_rate_and_phase(P2: jnp.ndarray, idx_lo: int, idx_hi: int, Nfft: int,
                             mask_offset: int = 0):
    """Symbol rate + phase from the spectrum of summed matched-filter power.

    Parity with ``sumXCorrBuffMasks`` + R2C FFT + ``findCodeRateAndPhase``
    (cuda_kernels.cu:191-320, demodulator_base.py:711-752): restrict the
    rfft-magnitude argmax to bins [Nfft/(1.1·spsym), Nfft/(0.9·spsym));
    spSym = Nfft/k*, codeOffset = −phase/π·spSym/2 (wrapped positive).

    P2: (M, N) f32 |X|^2. Returns (spSym, codeOffset, peak_val).
    """
    M = P2.shape[0]
    power = jnp.sum(P2[mask_offset : M - mask_offset], axis=0)
    return find_code_rate_and_phase_from_power(power, idx_lo, idx_hi, Nfft)


def _window_scan_tree(V, payload, W):
    """Log-shift elementwise max/argmax tree (two-cover for non-pow2 W)."""
    M = V.shape[0]

    def shift_left(arrs, n):
        out = []
        for a, f in zip(arrs, (-1.0, 0.0)):
            pad = jnp.full((M, n), f, a.dtype)
            out.append(jnp.concatenate([a[:, n:], pad], axis=1))
        return out

    def combine(arrs, shifted):
        right = shifted[0] > arrs[0]  # strict: ties keep the earlier index
        return [jnp.where(right, s, a) for a, s in zip(arrs, shifted)]

    arrs = [V, payload]
    span = 1
    while span * 2 <= W:
        arrs = combine(arrs, shift_left(arrs, span))
        span *= 2
    if W - span > 0:  # two-cover for non-power-of-two windows
        arrs = combine(arrs, shift_left(arrs, W - span))
    return arrs[0], arrs[1]


def _block_scan_prefix_suffix(Vp, Pp, W: int):
    """Per-aligned-block max prefix and suffix scans with the
    earliest-index tie-break (accumulators replace only on
    strictly-greater, so earlier columns win ties — the single source
    of the invariant shared by the vanherk window scan and the
    blockscan slot route). Vp/Pp: (..., nb, W); returns
    (pref_v, pref_p, suf_v, suf_p), each (..., nb*W)."""
    flat = Vp.shape[:-2] + (Vp.shape[-2] * W,)

    pv, pp = Vp[..., 0], Pp[..., 0]
    prefs = [(pv, pp)]
    for i in range(1, W):
        nv, np_ = Vp[..., i], Pp[..., i]
        take = nv > pv  # strictly greater: earlier index wins ties
        pv = jnp.where(take, nv, pv)
        pp = jnp.where(take, np_, pp)
        prefs.append((pv, pp))
    pref_v = jnp.stack([a for a, _ in prefs], axis=-1).reshape(flat)
    pref_p = jnp.stack([b for _, b in prefs], axis=-1).reshape(flat)

    sv, sp = Vp[..., W - 1], Pp[..., W - 1]
    sufs = [(sv, sp)]
    for i in range(W - 2, -1, -1):
        cv, cp = Vp[..., i], Pp[..., i]
        keep = sv > cv  # the (earlier) current element wins ties
        sv = jnp.where(keep, sv, cv)
        sp = jnp.where(keep, sp, cp)
        sufs.append((sv, sp))
    sufs.reverse()
    suf_v = jnp.stack([a for a, _ in sufs], axis=-1).reshape(flat)
    suf_p = jnp.stack([b for _, b in sufs], axis=-1).reshape(flat)
    return pref_v, pref_p, suf_v, suf_p


def _window_scan_vanherk(V, payload, W):
    """van Herk / Gil-Werman window max: a block prefix scan + a block
    suffix scan + one combine — ~2(W-1)/W + 1 array passes total,
    independent of W, vs the tree's ~2·ceil(log2 W) full passes. Scan
    steps touch (rows, nBlocks) slices, so the whole thing is ~3 HBM
    passes. Tie-break is kept bit-identical to the tree (earliest index
    wins): see _block_scan_prefix_suffix; the combine prefers the
    suffix (earlier) segment on ties.
    """
    M, L = V.shape
    nb = -(-(L + W - 1) // W)
    padn = nb * W - L
    Vp = jnp.concatenate([V, jnp.full((M, padn), -1.0, V.dtype)],
                         axis=1).reshape(M, nb, W)
    Pp = jnp.concatenate([payload, jnp.zeros((M, padn), payload.dtype)],
                         axis=1).reshape(M, nb, W)

    pref_v, pref_p, suf_v, suf_p = _block_scan_prefix_suffix(Vp, Pp, W)

    # window j = max(suffix-of-block at j, prefix at j+W-1); the suffix
    # segment is earlier, so it wins ties
    pv2, pp2 = pref_v[:, W - 1:], pref_p[:, W - 1:]
    right = pv2[:, :L] > suf_v[:, :L]
    return (jnp.where(right, pv2[:, :L], suf_v[:, :L]),
            jnp.where(right, pp2[:, :L], suf_p[:, :L]))


#: columns of the symbol-slot gather source (2 carry data, the rest pad
#: rows to a wider transfer). Default 2; the chunked batch path
#: overrides to 8 per graph (dsp.block.build_process_batch) — values
#: read are identical either way, so mixing shapes stays bit-identical.
#: Both widths were tuned on the system's first accelerator and have not
#: been re-derived for the GPU.
GATHER_PAD_COLS = 2

_WINDOW_SCANS = {"tree": _window_scan_tree, "vanherk": _window_scan_vanherk}
#: strategy for the per-position window max/argmax (see functions above);
#: both are bit-identical (exactness-tested), chosen by measurement
WINDOW_SCAN_ROUTE = "tree"


def sliding_window_argmax(P2: jnp.ndarray, W: int, extras=(),
                          extra_bounds=(), packed=False):
    """Per-position window max/argmax: V[:, j] = max P2[:, j:j+W),
    I[:, j] = its absolute column index (earliest on ties), computed
    with a log-shift elementwise tree — no gathers. ``extras``: (row,)
    arrays carried through the selection, returning the winner's value.

    The selection compares only V, so the index and every extra ride
    the tree as ONE f32 payload ``(I*b0 + e0)*b1 + e1 ...`` — exact
    while ``(N+W)*prod(bounds) < 2^24`` — halving the tree's memory
    traffic vs carrying separate arrays. Callers MUST
    pass ``extra_bounds`` (one static exclusive upper bound per extra,
    values assumed nonnegative ints); a missing bound or a bounds
    product that leaves f32's exact-integer range raises ValueError.

    Returns (V, I, *extras_selected), each (rows, N + W) with the last
    W columns padded (-1 for values, 0 for indices/extras) — or, with
    ``packed=True``, (V, payload_f32, prod_bounds) where the caller
    decodes ``I = payload // prod_bounds`` and extras by repeated
    divmod (cheapest when decode happens after a small slot gather).
    """
    M = P2.shape[0]
    N = P2.shape[1]
    if len(extras) != len(extra_bounds):
        raise ValueError("one static exclusive bound per extra is required")
    prod_b = 1
    for b in extra_bounds:
        prod_b *= int(b)
    if (N + W) * prod_b >= 1 << 24:
        raise ValueError("payload exceeds f32-exact range; shrink bounds")

    V = jnp.concatenate([P2, jnp.full((M, W), -1.0, P2.dtype)], axis=1)
    pay = jnp.arange(N + W, dtype=jnp.int32)
    for e, b in zip(extras, extra_bounds):
        pay = pay * jnp.int32(b) + jnp.concatenate(
            [e.astype(jnp.int32), jnp.zeros((W,), jnp.int32)])
    payload = jnp.broadcast_to(pay.astype(jnp.float32)[None, :], V.shape)
    V, payload = _WINDOW_SCANS[WINDOW_SCAN_ROUTE](V, payload, W)
    if packed:
        return V, payload, prod_b
    p = payload.astype(jnp.int32)
    decoded = []
    for b in reversed(extra_bounds):
        decoded.append(p % jnp.int32(b))
        p = p // jnp.int32(b)
    return (V, p) + tuple(reversed(decoded))


def _blockscan_pack(Vcol: jnp.ndarray, pay: jnp.ndarray, W: int):
    """Slot-pruned window scan, phase 1: per-block prefix/suffix
    max-scans whose combine is DEFERRED until after the slot row read.

    The sliding-window tree computes the window max at EVERY one of N+W
    start positions, but the symbol slots read only ~W of every
    ~spSym columns — at flagship shapes half the columns (and every
    tree pass over all of them) are never consumed. van Herk / Gil-
    Werman decomposition instead: any W-window [A, A+W) spans exactly
    the suffix of aligned W-block q = A//W from offset r = A%W plus the
    prefix of block q+1 through r-1, so two W-step block scans (each
    touching (nb,)-slices, ~2 array passes total) replace the tree's
    ~2·ceil(log2 W) full passes, and the final max happens per SLOT on
    numSymMax-sized arrays.

    Returns Z (nb·W, 4) f32 with Z[j] = [suf_v[j], suf_pay[j],
    pref_v[j+W-1], pref_pay[j+W-1]]: the window max for start j is
    max(Z[j,0], Z[j,2]) (prefix wins only if strictly greater, so the
    earlier suffix segment wins ties — identical tie-break to the
    tree, exactness-tested). The r=0 case degenerates to both halves
    covering block q and stays exact.
    """
    N = Vcol.shape[0]
    nb = -(-N // W)
    padn = nb * W - N
    Vp = jnp.concatenate([Vcol, jnp.full((padn,), -1.0, Vcol.dtype)]).reshape(nb, W)
    Pp = jnp.concatenate([pay, jnp.zeros((padn,), pay.dtype)]).reshape(nb, W)

    pref_v, pref_p, suf_v, suf_p = _block_scan_prefix_suffix(Vp, Pp, W)

    # shift the prefix row to j+W-1 so ONE row read serves both halves
    pv_sh = jnp.concatenate([pref_v[W - 1:], jnp.full((W - 1,), -1.0, pref_v.dtype)])
    pp_sh = jnp.concatenate([pref_p[W - 1:], jnp.zeros((W - 1,), pref_p.dtype)])
    return jnp.stack([suf_v, suf_p, pv_sh, pp_sh], axis=1)  # (nb*W, 4)


def _select_rows_onehot(packed: jnp.ndarray, A: jnp.ndarray, Q: int = 128):
    """R[i] = packed[A[i]] as two exact one-hot contractions instead of
    a row gather. Factor the row index A = Q*q + r: contract q with an
    matmul against a (G, Q*C) retiling of ``packed``, then select r
    elementwise. Every one-hot term is exactly 0 or 1 in f32 so the
    sums reproduce the gathered values BIT-EXACTLY. Kept as an A/B
    alternative to the gather (``select_route="onehot"``).

    precision=HIGHEST is CORRECTNESS, not tuning: at default precision
    an accelerator may round f32 operands (bfloat16 passes, or TF32 on
    the GPU), and the payload column carries packed integers up to
    ~2^23 — the select would return quantized garbage, which CPU tests
    cannot catch because CPU matmuls are always full f32. With HIGHEST
    the products are true f32 and the select stays bit-exact.
    """
    n_rows, C = packed.shape
    G = -(-n_rows // Q)
    p2 = jnp.pad(packed, ((0, G * Q - n_rows), (0, 0))).reshape(G, Q * C)
    q = A // Q
    r = A % Q
    oq = (q[:, None] == jnp.arange(G, dtype=A.dtype)[None, :]).astype(jnp.float32)
    tmp = jnp.einsum("sg,gk->sk", oq, p2,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST).reshape(-1, Q, C)
    orr = (r[:, None] == jnp.arange(Q, dtype=A.dtype)[None, :]).astype(jnp.float32)
    return jnp.einsum("sq,sqc->sc", orr, tmp,
                      precision=jax.lax.Precision.HIGHEST)


#: window-scan evaluation inside find_centres: "window" precomputes the
#: sliding-window max at all N+W positions (WINDOW_SCAN_ROUTE strategy);
#: "blockscan" defers the van Herk combine past the slot row read so
#: only per-block scans touch full-N arrays (see _blockscan_pack).
#: Both are bit-identical (exactness-tested); default by measurement.
CENTRES_SCAN_ROUTE = "window"


def _select_rows_grouped(packed: jnp.ndarray, A: jnp.ndarray, sp_max: float,
                         group: int = 8):
    """R[i] = packed[A[i]] exploiting that A is monotone with bounded
    stride: ``group`` consecutive slots always land inside a patch of
    span (group-1)*sp_max+1 rows, so ONE gather of two aligned
    tile-rows per GROUP replaces ``group`` tiny row gathers. The
    within-patch read is an exact iota-compare one-hot (0/1 f32
    contraction -> bit-exact), a few MFLOP.

    ``sp_max``: static upper bound on A[i+1]-A[i] (the demod graph's
    slot stride is spSym <= Nfft/code_idx_lo by construction of the
    timing-band argmax). packed: (L, C); A: (S,) int32 nondecreasing.
    """
    L, C = packed.shape
    S = A.shape[0]
    span = int(np.ceil((group - 1) * float(sp_max))) + 1
    # worst alignment: A[g0] sits at tile offset Tp-1, so the group ends
    # at offset Tp-1 + span-1; two tiles cover it iff Tp >= span - 1
    Tp = 8
    while Tp < span - 1:
        Tp *= 2
    # tiles of Tp rows; a patch = 2 consecutive tiles always covers the
    # group: base = (A[g*group]//Tp)*Tp <= A[i] <= base + Tp + span - 2 < base + 2Tp
    G = group
    Sg = -(-S // G)
    A_pad = jnp.concatenate(
        [A, jnp.broadcast_to(A[-1:], (Sg * G - S,))]) if Sg * G != S else A
    nt = -(-L // Tp) + 1  # +1: the q+1 tile read past the end stays in range
    Zt = jnp.concatenate(
        [packed, jnp.zeros((nt * Tp - L, C), packed.dtype)]).reshape(nt, Tp * C)
    Ag = A_pad.reshape(Sg, G)
    q = Ag[:, 0] // Tp                       # (Sg,)
    rows = jnp.stack([q, q + 1], axis=1)     # (Sg, 2)
    patch = jnp.take(Zt, rows, axis=0)       # (Sg, 2, Tp*C)
    patch = patch.reshape(Sg, 2 * Tp, C)
    rel = Ag - (q * Tp)[:, None]             # (Sg, G) in [0, 2*Tp)
    sel = (rel[:, :, None] == jnp.arange(2 * Tp, dtype=A.dtype)[None, None, :]
           ).astype(packed.dtype)            # exact 0/1
    # HIGHEST: the payload ints exceed bf16's and TF32's mantissas —
    # default matmul precision would quantize them (see _select_rows_onehot)
    R = jnp.einsum("sgt,stc->sgc", sel, patch,
                   preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST)
    return R.reshape(Sg * G, C)[:S]


def find_centres(P2: jnp.ndarray, spSym, codeOffset, *, Nfft: int, windowWidth: int,
                 spsymMin: int, numSymMax: int, clip_mask=None,
                 select_route: str = "gather", scan_route: str = None,
                 sp_max: float = None, cols=None, num_masks: int = None,
                 gather_pad: int = None):
    """Windowed symbol detection (parity: ``findCentres``,
    cuda_kernels.cu:78-146, abs² metric).

    One symbol slot per predicted centre ``x*spSym + codeOffset``; pick
    the (mask, offset) with the largest magnitude in a ``windowWidth``
    window; emit (winning mask, centre sample, magnitude).

    Formulation: the mask axis is reduced FIRST (per-column max +
    argmax — max over (mask, offset) is associative, so this loses no
    information), then the per-window max/argmax over the single
    column-max row is precomputed for EVERY start position
    (``sliding_window_argmax``) with the winning-mask index riding the
    tree, and each slot reads one row of a packed (N+W, C) matrix — an
    M-mask graph does an M-times smaller tree and gather than a per-mask
    formulation.

    Tie-break: (offset, mask)-lexicographic first-win — the earliest
    window sample wins, then the lowest mask at that sample. The CUDA
    kernel iterates masks outer / samples inner (cuda_kernels.cu:126-139)
    so its order is (mask, offset); the two differ only when two
    DIFFERENT (mask, sample) pairs tie on exact float magnitude, which
    real signals do not produce. The numpy golden (dsp/reference.py)
    and the sharded path (parallel/sharded_demod.py) implement this
    same (offset, mask) order.

    Window placement at the array edges is clamped to keep full
    W-sample windows (the CUDA kernel truncates instead); the affected
    first/last slots lie inside the overlap margin that block healing
    discards.

    ``clip_mask`` (optional, (Nfft,) bool): a dilated interference mask
    carried through the selection tree and sampled at each slot's
    winning sample — the trust −2 tagging of dsp/block.py without a
    per-slot gather. When given, a 6th output (bool[numSymMax]) is
    appended.

    ``select_route``: "gather" (default) or "onehot" (bit-exact one-hot
    matmul row select, see ``_select_rows_onehot``) or "grouped".

    ``cols``: optional precomputed ``(Vcol, m_star)`` per-column
    (max, argmax) over masks from the fused mask-bank route
    (``apply_best_doppler_power_cols``); requires ``num_masks`` and
    makes ``P2`` unused (pass None).

    Returns (symbols i32[numSymMax], centres i32[numSymMax],
             mags f32[numSymMax], nSym i32, spc f32[, clip b1[numSymMax]]).
    """
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
        # fused mask-bank route: the per-column (max, argmax) over masks
        # arrive precomputed from the inverse transform
        # (apply_best_doppler_power_cols) and P2 never exists
        Vcol, m_star = cols
        m_star = m_star.astype(jnp.int32)
        M = num_masks
    else:
        m_star = jnp.argmax(P2, axis=0).astype(jnp.int32)  # lowest mask on ties
        Vcol = jnp.max(P2, axis=0)  # (N,)
        M = P2.shape[0]
    extras = (m_star,) if clip_mask is None else (m_star, clip_mask)
    bounds = (M,) if clip_mask is None else (M, 2)
    if scan_route is None:
        scan_route = CENTRES_SCAN_ROUTE

    if scan_route == "blockscan":
        prod_b = 1
        for b in bounds:
            prod_b *= int(b)
        if N * prod_b >= 1 << 24:
            raise ValueError("payload exceeds f32-exact range; shrink bounds")
        pay = jnp.arange(N, dtype=jnp.int32)
        for e, b in zip(extras, bounds):
            pay = pay * jnp.int32(b) + e.astype(jnp.int32)
        Z = _blockscan_pack(Vcol, pay.astype(jnp.float32), W)  # (nb*W, 4)
        if select_route == "onehot":
            R4 = _select_rows_onehot(Z, A)
        elif select_route == "grouped":
            R4 = _select_rows_grouped(Z, A, sp_max)
        else:
            R4 = jnp.take(Z, A, axis=0)  # (numSymMax, 4)
        # deferred combine on slot-sized arrays: prefix half wins only
        # if strictly greater (suffix = earlier columns keeps ties)
        right = R4[:, 2] > R4[:, 0]
        mags = jnp.where(right, R4[:, 2], R4[:, 0])
        pf = jnp.where(right, R4[:, 3], R4[:, 1]).astype(jnp.int32)
    else:
        V, payload, prod_b = sliding_window_argmax(
            Vcol[None, :], W, extras, extra_bounds=bounds, packed=True)

        # value + packed (index, mask[, clip]) payload: 2 f32 columns
        # for ONE major-axis row gather; decode after the small slot
        # read (payload ints < 2^24 are exact in f32). The row is PADDED
        # to GATHER_PAD_COLS; values read are identical.
        pad = GATHER_PAD_COLS if gather_pad is None else gather_pad
        if pad < 2:
            # the packed row always carries 2 real columns (V, payload);
            # a smaller pad would silently do nothing
            raise ValueError(f"gather pad must be >= 2, got {pad}")
        packed = jnp.stack(
            [V[0], payload[0]] + [jnp.zeros_like(V[0])] * (pad - 2), axis=1)
        if select_route == "onehot":
            # latency mode (single-block streaming): see _select_rows_onehot
            R = _select_rows_onehot(packed, A)
        elif select_route == "grouped":
            # grouped patch-gather (needs the static stride bound)
            R = _select_rows_grouped(packed, A, sp_max)
        else:
            R = jnp.take(packed, A, axis=0)  # (numSymMax, 2)

        mags = R[:, 0]
        pf = R[:, 1].astype(jnp.int32)
    if clip_mask is not None:
        at_win_i = pf % jnp.int32(2)
        pf = pf // jnp.int32(2)
    symbols = pf % jnp.int32(M)
    j_win = pf // jnp.int32(M)
    maxK = (j_win - A).astype(jnp.int32)

    centres = jnp.trunc(x * spc - Wl + maxK.astype(jnp.float32)).astype(jnp.int32) + comp
    nSym = (Nfft / spc).astype(jnp.int32)
    if clip_mask is not None:
        at_win = at_win_i > 0
        return symbols, centres, mags, nSym, spc, at_win
    return symbols, centres, mags, nSym, spc


def extract_bits_lut(symbols: jnp.ndarray, bitLUT: jnp.ndarray) -> jnp.ndarray:
    """Centre-bit LUT path (reference demodulator_base.py:1012-1023).

    One-hot select instead of ``jnp.take``: the LUT has only num_masks
    entries."""
    M = bitLUT.shape[0]
    sel = symbols[:, None] == jnp.arange(M, dtype=symbols.dtype)[None, :]
    return (sel * bitLUT[None, :].astype(jnp.int32)).sum(axis=1).astype(jnp.int8)


def extract_bits_nrzs(symbols: jnp.ndarray, symbolLUT: jnp.ndarray):
    """NRZ-S 3-D LUT path for BPSK phase-ambiguity resolution
    (reference demodulator_base.py:1026-1051).

    bits[i] derives from the (symbols[i], symbols[i+1]) transition;
    returns (bits int8[n-1... padded to n], error bool[n]) where a
    transition matching neither table entry is an error (bit forced 0,
    trust −1).
    """
    s_prev = symbols
    s_next = jnp.roll(symbols, -1)
    # one-hot row selection instead of jnp.take: an exact integer
    # (n, M) x (M, K) product
    M = symbolLUT.shape[0]
    sel = (s_prev[:, None] == jnp.arange(M, dtype=s_prev.dtype)[None, :]
           ).astype(jnp.int32)
    ones_tbl = sel @ symbolLUT[:, 0, :].astype(jnp.int32)  # (n, K)
    zeros_tbl = sel @ symbolLUT[:, 1, :].astype(jnp.int32)
    res1 = jnp.any(s_next[:, None] == ones_tbl, axis=1)
    res0 = jnp.any(s_next[:, None] == zeros_tbl, axis=1)
    err = ~(res1 | res0)
    bits = jnp.where(err, 0, res1.astype(jnp.int8)).astype(jnp.int8)
    return bits, err


def dilate_mask_dynamic(mask: jnp.ndarray, halfwidth,
                        hw_max: int = 2048) -> jnp.ndarray:
    """Binary dilation with a runtime-valued half width via prefix sums.

    Used to tag trust −2 within ±2·spSym of clipped interference peaks
    (reference demodulator_base.py:830-837).

    The windowed count ``c[i+hw] - c[i-hw-1]`` is read with two
    CONTIGUOUS ``dynamic_slice``s of a padded cumsum instead of two
    N-element gathers. Exact for
    ``halfwidth <= hw_max``; wider requests clamp (a dilation radius
    beyond 2048 samples only arises from garbage symbol-rate estimates
    on pure noise, where trust tagging is moot anyway).
    """
    N = mask.shape[0]
    c = jnp.cumsum(mask.astype(jnp.int32))
    hw = jnp.clip(halfwidth.astype(jnp.int32), 0, hw_max)
    # cp[j] = c[j - (hw_max+1)], with c = 0 before the start and
    # c[N-1] past the end (matches the clip-to-edge semantics)
    cp = jnp.concatenate([
        jnp.zeros((hw_max + 1,), jnp.int32), c,
        jnp.full((hw_max,), c[N - 1], jnp.int32),
    ])
    hi = jax.lax.dynamic_slice(cp, (hw_max + 1 + hw,), (N,))  # c[min(i+hw, N-1)]
    lo = jax.lax.dynamic_slice(cp, (hw_max - hw,), (N,))      # c[i-hw-1] or 0
    return (hi - lo) > 0


def compute_snr(absS: jnp.ndarray, fft_lo, fft_hi, window: int, Nfft: int):
    """SNR from signal bins vs mirrored-spectrum noise bins
    (reference demodulator_base.py:635-667). Circular ranges are
    evaluated with boolean masks so the graph stays statically shaped.
    """
    k = jnp.arange(Nfft, dtype=jnp.int32)

    def circ_mean(a, b):
        a = jnp.mod(a, Nfft)
        span = jnp.mod(b - a, Nfft)
        rel = jnp.mod(k - a, Nfft)
        sel = rel < span
        return jnp.sum(jnp.where(sel, absS, 0.0)) / jnp.maximum(jnp.sum(sel), 1)

    sig = circ_mean(fft_lo - window, fft_hi + window)
    noise = circ_mean(fft_lo - window + Nfft // 2, fft_hi + window + Nfft // 2)
    ratio = sig / noise - 1.0
    return jnp.where(ratio > 0, 20.0 * jnp.log10(jnp.where(ratio > 0, ratio, 1.0)), -jnp.inf)
