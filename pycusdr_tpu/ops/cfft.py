"""Split-complex FFT wrappers over ``jnp.fft``.

The block graph carries complex tensors as a leading length-2 axis
``[re, im]`` of float32. The wrappers below keep that interface and
convert at their boundary: ``lax.complex`` in, ``jnp.fft`` (which XLA
lowers to cuFFT on the GPU and to its own FFT on the CPU), real and
imaginary parts out. This is the counterpart of the reference's cuFFT
binding (``lib/cufft.py``).

Convention: a "split" array has shape (..., 2, N) — re = x[..., 0, :],
im = x[..., 1, :].
"""

import jax.numpy as jnp
import numpy as np
from jax import lax


def c2ri(x: np.ndarray) -> np.ndarray:
    """complex host array (..., N) -> float32 split array (..., 2, N)."""
    x = np.asarray(x)
    return np.stack([x.real, x.imag], axis=-2).astype(np.float32)


def ri2c(x) -> np.ndarray:
    """split array (..., 2, N) (device or host) -> complex64 host array."""
    x = np.asarray(x)
    return (x[..., 0, :] + 1j * x[..., 1, :]).astype(np.complex64)


def cmul(ar, ai, br, bi):
    """Elementwise complex multiply on split parts."""
    return ar * br - ai * bi, ar * bi + ai * br


def _to_complex(x):
    return lax.complex(x[..., 0, :].astype(jnp.float32),
                       x[..., 1, :].astype(jnp.float32))


def _to_split(z):
    return jnp.stack([jnp.real(z), jnp.imag(z)], axis=-2)


def _ifft_unnorm(x):
    """N·ifft of a split array, as complex (cuFFT's unnormalised inverse;
    N is a power of two, so the rescale is exact)."""
    n = x.shape[-1]
    return jnp.fft.ifft(_to_complex(x)) * n


def fft_ri(x):
    """Forward FFT of a split array (..., 2, N) -> (..., 2, N)."""
    return _to_split(jnp.fft.fft(_to_complex(x)))


def fft_real_ri(x):
    """Forward FFT of a REAL array (..., N) -> (..., 2, N), full length."""
    return _to_split(jnp.fft.fft(x.astype(jnp.float32)))


def ifft_unnorm_ri(x):
    """Unnormalised inverse FFT (matches cuFFT's inverse, i.e. N·ifft)."""
    return _to_split(_ifft_unnorm(x))


def ifft_unnorm_power_ri(x):
    """|N·ifft(x)|² for a split array (..., 2, N) -> (..., N).

    The matched filter bank only needs the lag-domain POWER (abs²
    symbol metric, cuda_kernels.cu:78-146)."""
    z = _ifft_unnorm(x)
    zr, zi = jnp.real(z), jnp.imag(z)
    return zr * zr + zi * zi


def ifft_unnorm_power_colreduce_ri(x, sum_lo: int, sum_hi: int):
    """Mask-axis reductions of |N·ifft(x)|².

    ``x``: (..., M, 2, N) split spectra (M = mask axis). Returns
    ``(colsum, colmax, colargmax)``, each (..., N):

    - ``colsum[n]  = Σ_{m in [sum_lo, sum_hi)} |X_m[n]|²`` — the symbol-
      timing power waveform (reference ``sumXCorrBuffMasks``,
      cuda_kernels.cu:191-205, mask subset via CODE_SEARCH_MASK_OFFSET);
    - ``colmax / colargmax`` — per-position max/argmax over ALL masks
      with the lowest mask winning ties (reference ``findCentres`` mask
      loop, cuda_kernels.cu:78-146) — symbol detection's first step.

    These are the only consumers of the matched-filter power
    (dsp/block.py), and XLA fuses the three reductions into one pass
    over the power. Bit-identical to reducing ``ifft_unnorm_power_ri``'s
    result (same ops — exactness-tested in tests/test_dsp_golden.py).
    """
    power = ifft_unnorm_power_ri(x)  # (..., M, N)
    return (power[..., sum_lo:sum_hi, :].sum(axis=-2),
            power.max(axis=-2),
            power.argmax(axis=-2).astype(jnp.int32))


def rfft_ri(x_real):
    """Real-input FFT: (..., N) f32 -> (..., 2, N//2+1) split spectrum."""
    return _to_split(jnp.fft.rfft(x_real.astype(jnp.float32)))


def band_dft_real(x_real, lo: int, hi: int):
    """Forward-DFT bins [lo, hi) of a REAL input — (..., N) f32 ->
    (..., 2, hi-lo) split spectrum, i.e. ``rfft_ri(x)[..., lo:hi]``.

    The symbol-timing search reads only this band (the reference
    restricts its argmax to bins [Nfft/(1.1·spSym), Nfft/(0.9·spSym)),
    cuda_kernels.cu:236-320)."""
    n = x_real.shape[-1]
    if not 0 <= lo < hi <= n // 2 + 1:
        raise ValueError(f"band [{lo}, {hi}) outside the rfft range of N={n}")
    return rfft_ri(x_real)[..., lo:hi]
