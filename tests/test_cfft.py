"""Split-complex FFT wrappers (ops/cfft): the counterpart of the
reference's cuFFT binding (lib/cufft.py). Golden vs numpy across sizes,
batching, the real-input transforms, the timing band and the mask-axis
colreduce."""

import numpy as np
import pytest

import jax

from pycusdr_tpu.ops.cfft import (
    band_dft_real,
    c2ri,
    cmul,
    fft_real_ri,
    fft_ri,
    ifft_unnorm_power_colreduce_ri,
    ifft_unnorm_power_ri,
    ifft_unnorm_ri,
    ri2c,
    rfft_ri,
)


@pytest.mark.parametrize("n", [8, 64, 256, 512, 4096, 65536])
def test_fft_matches_numpy(n):
    rng = np.random.RandomState(n)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    X = ri2c(jax.jit(fft_ri)(c2ri(x)))
    ref = np.fft.fft(x)
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 2e-6


@pytest.mark.parametrize("n", [64, 512, 8192])
def test_ifft_unnormalised(n):
    rng = np.random.RandomState(n + 1)
    x = (rng.randn(n) + 1j * rng.randn(n)).astype(np.complex64)
    X = np.fft.fft(x).astype(np.complex64)
    xi = ri2c(jax.jit(ifft_unnorm_ri)(c2ri(X)))
    assert np.max(np.abs(xi - x * n)) / (np.max(np.abs(x)) * n) < 2e-6


@pytest.mark.parametrize("n", [64, 512, 4096, 65536])
def test_rfft_matches_numpy(n):
    rng = np.random.RandomState(n + 2)
    r = rng.randn(n).astype(np.float32)
    R = ri2c(jax.jit(rfft_ri)(r))
    ref = np.fft.rfft(r)
    assert np.max(np.abs(R - ref)) / np.max(np.abs(ref)) < 2e-6
    assert R.shape == (n // 2 + 1,)


@pytest.mark.parametrize("n,lo,hi", [
    (65536, 3724, 4552),   # the flagship timing band (spsym 16)
    (4096, 0, 1),          # DC only
    (4096, 2047, 2049),    # straddling a k2-tile boundary
    (512, 1, 257),         # full lower half, small n
    (65536, 32760, 32769), # top of the rfft range incl. Nyquist
])
def test_band_dft_real_matches_rfft(n, lo, hi):
    rng = np.random.RandomState(lo + 5)
    r = rng.randn(n).astype(np.float32)
    B = ri2c(jax.jit(lambda x: band_dft_real(x, lo, hi))(r))
    ref = np.fft.rfft(r)[lo:hi]
    assert B.shape == (hi - lo,)
    assert np.max(np.abs(B - ref)) / np.max(np.abs(np.fft.rfft(r))) < 2e-6


def test_band_dft_real_batched():
    rng = np.random.RandomState(11)
    r = rng.randn(3, 4096).astype(np.float32)
    B = ri2c(jax.jit(lambda x: band_dft_real(x, 100, 400))(r))
    ref = np.stack([np.fft.rfft(row)[100:400] for row in r])
    assert np.max(np.abs(B - ref)) / np.max(np.abs(ref)) < 2e-6


@pytest.mark.parametrize("n", [1 << 8, 1 << 12, 1 << 16, 1 << 17])
def test_split_wrappers_match_numpy(n):
    """Every split wrapper equals numpy's transform, 2^8 to 2^17 (the
    STX block length), on a batch of two rows."""
    rng = np.random.RandomState(n + 9)
    x = (rng.randn(2, n) + 1j * rng.randn(2, n)).astype(np.complex64)
    x128 = x.astype(np.complex128)

    def rel(got, ref):
        return np.max(np.abs(got - ref)) / np.max(np.abs(ref))

    assert rel(ri2c(jax.jit(fft_ri)(c2ri(x))), np.fft.fft(x128, axis=-1)) < 2e-6
    r = x.real.astype(np.float32)
    R = ri2c(jax.jit(fft_real_ri)(r))
    assert rel(R, np.fft.fft(r.astype(np.float64), axis=-1)) < 2e-6
    assert rel(ri2c(jax.jit(rfft_ri)(r)), np.fft.rfft(r.astype(np.float64), axis=-1)) < 2e-6
    inv = ri2c(jax.jit(ifft_unnorm_ri)(c2ri(x)))
    assert rel(inv, np.fft.ifft(x128, axis=-1) * n) < 2e-6
    P = np.asarray(jax.jit(ifft_unnorm_power_ri)(c2ri(x)))
    pref = np.abs(np.fft.ifft(x128, axis=-1) * n) ** 2
    assert P.shape == (2, n)
    assert np.max(np.abs(P - pref)) / pref.max() < 4e-6


@pytest.mark.parametrize("sum_lo,sum_hi", [(0, 8), (1, 7)])
def test_colreduce_matches_plain_reduction(sum_lo, sum_hi):
    """The mask-axis colreduce equals plain reductions of the power
    bit for bit (the fused and two-step bank routes rely on it), and
    numpy to f32 tolerance; argmax ties go to the lowest mask."""
    import jax.numpy as jnp

    n, M = 4096, 8
    rng = np.random.RandomState(sum_lo + 31)
    x = (rng.randn(3, M, n) + 1j * rng.randn(3, M, n)).astype(np.complex64)
    x[:, 5] = x[:, 2]  # exact tie between masks 2 and 5
    xri = c2ri(x)
    cs, cm, ca = jax.jit(lambda v: ifft_unnorm_power_colreduce_ri(
        v, sum_lo, sum_hi))(xri)

    def plain(v):
        p = ifft_unnorm_power_ri(v)
        return (jnp.sum(p[..., sum_lo:sum_hi, :], axis=-2), jnp.max(p, axis=-2),
                jnp.argmax(p, axis=-2).astype(jnp.int32))

    ps, pm, pa = jax.jit(plain)(xri)
    np.testing.assert_array_equal(np.asarray(cs), np.asarray(ps))
    np.testing.assert_array_equal(np.asarray(cm), np.asarray(pm))
    np.testing.assert_array_equal(np.asarray(ca), np.asarray(pa))
    assert not np.any(np.asarray(ca) == 5)

    pref = np.abs(np.fft.ifft(x.astype(np.complex128), axis=-1) * n) ** 2
    sref = pref[:, sum_lo:sum_hi].sum(axis=1)
    assert np.max(np.abs(np.asarray(cs) - sref)) / sref.max() < 4e-6
    assert np.max(np.abs(np.asarray(cm) - pref.max(axis=1))) / pref.max() < 4e-6


def test_band_dft_real_rejects_band_outside_rfft():
    r = np.zeros(512, np.float32)
    with pytest.raises(ValueError):
        band_dft_real(r, 10, 258)
    with pytest.raises(ValueError):
        band_dft_real(r, 5, 5)


def test_batched_and_multidim():
    rng = np.random.RandomState(8)
    x = (rng.randn(3, 5, 1024) + 1j * rng.randn(3, 5, 1024)).astype(np.complex64)
    X = ri2c(jax.jit(fft_ri)(c2ri(x)))
    ref = np.fft.fft(x, axis=-1)
    assert np.max(np.abs(X - ref)) / np.max(np.abs(ref)) < 2e-6


def test_cmul():
    a = np.array([1.0 + 2j, 3 - 1j])
    b = np.array([0.5 - 1j, -2 + 0.25j])
    r, i = cmul(a.real, a.imag, b.real, b.imag)
    np.testing.assert_allclose(np.asarray(r) + 1j * np.asarray(i), a * b)


def test_roundtrip_conversions():
    rng = np.random.RandomState(9)
    x = (rng.randn(4, 100) + 1j * rng.randn(4, 100)).astype(np.complex64)
    np.testing.assert_array_equal(ri2c(c2ri(x)), x)


def test_doppler_corr_route_matches_matmul():
    """The FFT-correlation Doppler energy equals the shifted matmul."""
    import jax.numpy as jnp

    from pycusdr_tpu.ops.doppler_search import (
        doppler_energy_corr,
        doppler_energy_matmul,
        make_qf_ri,
        make_shift_gather_indices,
    )

    N, M, D = 4096, 8, 48
    rng = np.random.RandomState(11)
    masks_f = (rng.randn(M, N) + 1j * rng.randn(M, N)).astype(np.complex64)
    P = np.abs(rng.randn(N)).astype(np.float32) * 100
    shifts = rng.randint(0, N, D).astype(np.int32)

    QT = (np.abs(masks_f) ** 2).T.astype(np.float32)
    sidx = make_shift_gather_indices(N, shifts)
    a = np.asarray(doppler_energy_matmul(jnp.asarray(P), jnp.asarray(QT), jnp.asarray(sidx)))
    b = np.asarray(doppler_energy_corr(jnp.asarray(P), jnp.asarray(make_qf_ri(masks_f)),
                                       jnp.asarray(shifts)))
    np.testing.assert_allclose(a, b, rtol=2e-4)

    # runtime grid recentre matches a pre-shifted grid
    c = np.int32(37)
    sidx_c = make_shift_gather_indices(N, (shifts + c) % N)
    a2 = np.asarray(doppler_energy_matmul(jnp.asarray(P), jnp.asarray(QT), jnp.asarray(sidx_c)))
    b2 = np.asarray(doppler_energy_corr(jnp.asarray(P), jnp.asarray(make_qf_ri(masks_f)),
                                        jnp.asarray(shifts), jnp.asarray(c)))
    np.testing.assert_allclose(a2, b2, rtol=2e-4)


def test_doppler_corr_dft_route_matches_matmul():
    """The pruned-output DFT Doppler energy (the batched-throughput
    route) equals the shifted matmul, with and without a runtime
    (traced) grid recentre."""
    import jax
    import jax.numpy as jnp

    from pycusdr_tpu.ops.doppler_search import (
        doppler_energy_corr_dft,
        doppler_energy_matmul,
        make_corr_dft_F,
        make_qf_ri,
        make_shift_gather_indices,
    )

    N, M, D = 4096, 8, 48
    rng = np.random.RandomState(11)
    masks_f = (rng.randn(M, N) + 1j * rng.randn(M, N)).astype(np.complex64)
    P = np.abs(rng.randn(N)).astype(np.float32) * 100
    shifts = rng.randint(0, N, D).astype(np.int32)

    QT = (np.abs(masks_f) ** 2).T.astype(np.float32)
    qf = jnp.asarray(make_qf_ri(masks_f))
    F = jnp.asarray(make_corr_dft_F(N, shifts))
    a = np.asarray(doppler_energy_matmul(
        jnp.asarray(P), jnp.asarray(QT),
        jnp.asarray(make_shift_gather_indices(N, shifts))))
    b = np.asarray(doppler_energy_corr_dft(jnp.asarray(P), qf, F))
    np.testing.assert_allclose(a, b, rtol=2e-4)

    # traced runtime recentre (the tracking path) matches a
    # pre-shifted grid, jitted so the phasor path actually traces
    c = np.int32(37)
    sidx_c = make_shift_gather_indices(N, (shifts + c) % N)
    a2 = np.asarray(doppler_energy_matmul(
        jnp.asarray(P), jnp.asarray(QT), jnp.asarray(sidx_c)))
    f = jax.jit(lambda p, cc: doppler_energy_corr_dft(p, qf, F, cc))
    b2 = np.asarray(f(jnp.asarray(P), jnp.asarray(c)))
    np.testing.assert_allclose(a2, b2, rtol=2e-4)


def test_block_graph_corr_route_golden():
    """A wide-grid spec (corr route) still matches the numpy reference."""
    import dataclasses

    import __graft_entry__ as g
    from pycusdr_tpu.dsp.block import CORR_ROUTE_MIN_D, build_process_block
    from pycusdr_tpu.dsp.reference import demod_block_numpy
    from pycusdr_tpu.dsp.spec import build_doppler_grid

    spec0 = g.tiny_spec()
    shifts, hz_lut, off_idx, fs = build_doppler_grid(
        spec0.Nfft, 48, spec0.baudRate, spec0.spsym, 437.3e6,
        spec0.centreFreqOffset, 7500.0)
    spec = dataclasses.replace(spec0, num_dopplers=48, dopp_shifts=shifts,
                               dopp_hz_lut=hz_lut, dopp_array_offset=0)
    assert spec.D >= CORR_ROUTE_MIN_D

    from conftest import make_fsk_signal
    rng = np.random.RandomState(21)
    bits = rng.randint(0, 2, spec.Nfft // int(spec.spsym))
    sig = make_fsk_signal(bits, int(spec.spsym), spec.centreFreqOffset / fs,
                          noise_std=0.05, seed=3)

    ref = demod_block_numpy(spec, sig)
    jx = {k: np.asarray(v) for k, v in build_process_block(spec)(c2ri(sig)).items()}
    assert abs(float(jx["doppler_hz"]) - ref["doppler_hz"]) < 1.0
    assert int(jx["shift"]) == ref["shift"]
    n = int(jx["nSym"])
    assert np.array_equal(jx["bits"][:n], ref["bits"][:n])
