"""Doppler search as one dense contraction — the search core of the Rx chain.

The reference implements the Doppler search as: build the 3-D
``doppler x mask x Nfft`` product tensor, batch-IFFT it back to the lag
domain, and reduce |.|^2 over the lag axis
(``cuda_kernels.cu:339-373`` + cuFFT batch + ``:421-480``). For UHF
defaults that is 512 IFFTs of 2^16 points and a 256 MB intermediate —
per block.

Here Parseval is used instead: the lag-domain energy of each (d, m)
correlation equals ``N * sum_k |S[(k+s_d) mod N]|^2 * |M[m,k]|^2``, so
the whole search collapses to

    E = Pshift @ Q.T        # (D,N) x (N,M), one matrix product

where ``P = |S|^2`` and ``Q = |M|^2`` is a precomputed constant. No 3-D
tensor, no IFFTs, three orders of magnitude less FLOPs and HBM traffic.
The estimator then mirrors ``findDopplerEst`` (cuda_kernels.cu:502-597):
top-2 weighted-average bin with a 10log10 match-quality metric, either
summed over all masks (FSK family) or averaged per mask.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

ABS_SUM_SCALE = 262144.0  # 2^18, matches reference blockAbsSumAtomic scaling

#: precision of the f32 Doppler contractions. On the GPU a float32
#: product at DEFAULT precision may run in TF32 (~10 mantissa bits);
#: HIGHEST keeps true f32, so the energies match the numpy reference to
#: f32 rounding and the Doppler bin never depends on the card's choice.
CONTRACTION_PRECISION = jax.lax.Precision.HIGHEST

#: operand dtype for the Doppler contraction: "float32" (default) or
#: "bfloat16" (f32 accumulation, ``preferred_element_type``; only the
#: operand quantization differs, gated by ``bench/ber_delta.py
#: --matmul-dtype bfloat16``). Graphs that need exact integer
#: arithmetic (one-hot selects, payload packing) never route through
#: this flag. Read at TRACE time — set via ``matmul_dtype(...)`` or build
#: graphs with ``dsp.block.build_process_block(..., fft_dtype=...)``.
MATMUL_DTYPE = "float32"


class matmul_dtype:
    """Scoped override of MATMUL_DTYPE (use around graph TRACING —
    i.e. around the build for jit=False graphs, or around the first
    call for jitted ones; ``dsp.block.build_process_block`` wraps its
    graph so the flag is pinned at build time regardless)."""

    def __init__(self, dt: str):
        if dt not in ("float32", "bfloat16"):
            raise ValueError(f"unknown matmul dtype {dt!r}")
        self.dt = dt

    def __enter__(self):
        global MATMUL_DTYPE
        self.old = MATMUL_DTYPE
        MATMUL_DTYPE = self.dt
        return self

    def __exit__(self, *exc):
        global MATMUL_DTYPE
        MATMUL_DTYPE = self.old
        return False


def _mm(sub: str, a, b):
    """Contraction honouring MATMUL_DTYPE, f32 accumulation."""
    dt = jnp.bfloat16 if MATMUL_DTYPE == "bfloat16" else jnp.float32
    return jnp.einsum(sub, a.astype(dt), b.astype(dt),
                      preferred_element_type=jnp.float32,
                      precision=CONTRACTION_PRECISION)


def make_shift_gather_indices(Nfft: int, shifts: np.ndarray) -> np.ndarray:
    """(D, Nfft) int32 gather map: row d holds (k + s_d) mod N."""
    return ((np.arange(Nfft, dtype=np.int64)[None, :] + np.asarray(shifts, np.int64)[:, None]) % Nfft).astype(np.int32)


def doppler_energy_matmul(P: jnp.ndarray, Q_T: jnp.ndarray, shift_idx: jnp.ndarray) -> jnp.ndarray:
    """E[d,m] = N/2^18 * sum_k P[(k+s_d)%N] Q[m,k] as one matmul.

    P: (N,) f32 signal power spectrum. Q_T: (N, M) f32 mask power bank
    (transposed, constant). shift_idx: (D, N) int32 constant gather map.
    """
    N = P.shape[0]
    Pshift = jnp.take(P, shift_idx, axis=0)  # (D, N)
    E = jax.lax.dot_general(
        Pshift,
        Q_T,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=CONTRACTION_PRECISION,
        preferred_element_type=jnp.float32,
    )
    return E * (N / ABS_SUM_SCALE)


def make_qf_ri(masks_f: np.ndarray) -> np.ndarray:
    """Constant for the correlation route: conj(FFT(|masks_f|^2)) as a
    split (M, 2, N) float32 bank."""
    Qf = np.conj(np.fft.fft(np.abs(masks_f.astype(np.complex128)) ** 2, axis=1))
    return np.stack([Qf.real, Qf.imag], axis=1).astype(np.float32)


def doppler_energy_corr(P: jnp.ndarray, Qf_ri: jnp.ndarray, shift_idx_cols: jnp.ndarray,
                        centre_shift=None) -> jnp.ndarray:
    """Doppler energy via circular FFT correlation at ALL N lags.

    Superseded in the default block graph by ``doppler_energy_corr_dft``
    (same math, output pruned to the D grid lags — ~7x fewer FLOPs);
    kept as the evaluation to use when the full lag curve is wanted
    (diagnostics, very large D) and as the independent cross-check the
    equivalence tests exercise.

    c_m[s] = ifft(fft(P) * conj(fft(|Q_m|^2)))[s] equals the shifted
    power product summed over k, so evaluating the FFT correlation once
    gives the energy at ALL N lags and the D grid points are a cheap
    column gather. This replaces the (D, N) shifted-spectrum
    materialization (17 MB for UHF defaults) with M+1 FFTs.

    P: (N,) f32 power spectrum; Qf_ri: (M, 2, N) from ``make_qf_ri``;
    shift_idx_cols: (D,) int32 grid shifts; centre_shift: optional
    runtime grid recentre (tracking mode). Returns (D, M) f32.
    """
    from pycusdr_tpu.ops.cfft import cmul, fft_ri, ifft_unnorm_ri

    N = P.shape[0]
    Pf = fft_ri(jnp.stack([P, jnp.zeros_like(P)]))
    mr, mi = cmul(Pf[0][None, :], Pf[1][None, :], Qf_ri[:, 0], Qf_ri[:, 1])
    corr = ifft_unnorm_ri(jnp.stack([mr, mi], axis=1))[:, 0]  # (M, N), N*c
    idx = shift_idx_cols
    if centre_shift is not None:
        idx = (idx + centre_shift) % N
    return corr[:, idx].T / ABS_SUM_SCALE


def make_corr_dft_F(Nfft: int, shifts: np.ndarray) -> np.ndarray:
    """Constant for the pruned-output correlation route: the inverse-DFT
    columns at the D grid lags, F[k, d] = exp(+2πi k s_d / N), as a
    split (2, N, D) float32 matrix (angles reduced mod N in int64 so
    every entry is exact)."""
    N = Nfft
    k = np.arange(N, dtype=np.int64)[:, None]
    s = np.asarray(shifts, np.int64)[None, :]
    ang = 2.0 * np.pi * ((k * s) % N) / N
    return np.stack([np.cos(ang), np.sin(ang)]).astype(np.float32)


def doppler_energy_corr_dft(P: jnp.ndarray, Qf_ri: jnp.ndarray, F_ri: jnp.ndarray,
                            centre_shift=None) -> jnp.ndarray:
    """Doppler energy via a pruned-output DFT — the batched-throughput path.

    ``doppler_energy_corr`` evaluates the correlation at ALL N lags
    (M inverse FFTs) and then reads only D of them. Here the inverse
    transform is evaluated ONLY at the D grid lags as one dense
    (M, N) x (N, D) contraction against the precomputed phasor matrix
    ``F``, with no column gather. Only the real part is computed (the correlation
    of two power spectra is real; the imag row was discarded anyway).

    A runtime grid recentre by ``centre_shift`` bins multiplies the
    frequency-domain product by the phasor exp(+2πi k c / N) before the
    static contraction (F itself never changes, so no recompile). The
    phasor's angle index (k*c) mod N is computed with the split
    k = 256*k_hi + k_lo so no int32 product overflows (k*c alone would
    reach 2^33 at STX shapes; the split caps products at N^2/256,
    int32-safe for N <= 2^19 — guarded below).

    P: (N,) f32 power spectrum; Qf_ri: (M, 2, N) from ``make_qf_ri``;
    F_ri: (2, N, D) from ``make_corr_dft_F``. Returns (D, M) f32,
    bit-compatible in meaning (not in rounding) with the FFT route.
    """
    from pycusdr_tpu.ops.cfft import cmul, fft_real_ri

    N = P.shape[0]
    Pf = fft_real_ri(P)
    mr, mi = cmul(Pf[0][None, :], Pf[1][None, :], Qf_ri[:, 0], Qf_ri[:, 1])
    if centre_shift is not None:
        if N > 1 << 19:
            raise ValueError("split-k phasor index overflows int32 beyond "
                             "N=2^19; widen the split for larger Nfft")
        c = jnp.mod(jnp.asarray(centre_shift, jnp.int32), N)
        k = jnp.arange(N, dtype=jnp.int32)
        k_hi, k_lo = k // 256, k % 256
        idx = jnp.mod(k_hi * jnp.mod(256 * c, N) + k_lo * c, N)
        ang = idx.astype(jnp.float32) * jnp.float32(2.0 * np.pi / N)
        mr, mi = cmul(mr, mi, jnp.cos(ang)[None, :], jnp.sin(ang)[None, :])
    E = _mm("mk,kd->md", mr, F_ri[0]) - _mm("mk,kd->md", mi, F_ri[1])
    return E.T / ABS_SUM_SCALE


def _top2_last_axis(vals: jnp.ndarray):
    v, i = jax.lax.top_k(vals, 2)
    return v[..., 0], i[..., 0], v[..., 1], i[..., 1]


@partial(jax.jit, static_argnames=("num_dopplers", "array_offset", "sum_all_masks"))
def find_doppler_estimate(E, num_dopplers: int, array_offset: int, sum_all_masks: bool):
    """Weighted top-2 Doppler estimate (cuda_kernels.cu:502-597 parity).

    Returns (dopp_idx float incl. noise-bin offset, quality_db).
    """
    off = array_offset
    if sum_all_masks:
        tot = E.sum(axis=1)
        v0, i0, v1, i1 = _top2_last_axis(tot[off : off + num_dopplers])
        i0 = (i0 + off).astype(jnp.float32)
        i1 = (i1 + off).astype(jnp.float32)
        wsum = i0 * v0 + i1 * v1
        # all-zero energy (e.g. an idle channel underflowing f32) must
        # degrade to index 0, not NaN — parity with the reference's
        # host-side ValueError fallback (demodulator_base.py:625-630)
        denom = v0 + v1
        dopp_idx = jnp.where(denom > 0, wsum / jnp.where(denom > 0, denom, 1.0), 0.0)
        if off > 0:
            quality = jnp.maximum(v0, v1) / tot[0]
        else:
            quality = jnp.where(denom > 0, wsum / (i0 + i1), 0.0)
        return dopp_idx, 10.0 * jnp.log10(quality)

    sub = E[off : off + num_dopplers, :].T  # (M, nd)
    v0, i0, v1, i1 = _top2_last_axis(sub)
    i0 = (i0 + off).astype(jnp.float32)
    i1 = (i1 + off).astype(jnp.float32)
    wsum = i0 * v0 + i1 * v1
    denom = v0 + v1
    idxs = jnp.where(denom > 0, wsum / jnp.where(denom > 0, denom, 1.0), 0.0)
    if off > 0:
        quals = jnp.maximum(v0, v1) / E[0, :]
    else:
        quals = jnp.where(denom > 0, wsum / (i0 + i1), 0.0)
    return idxs.mean(), 10.0 * jnp.log10(quals.mean())
