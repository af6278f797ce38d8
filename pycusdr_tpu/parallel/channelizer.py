"""Wideband polyphase channelizer front-end.

New capability over the reference (BASELINE config #5): a critically
sampled M-channel analysis filterbank that splits one wideband capture
into M baseband channels at fs/M each — the front door for "64-channel
wideband Rx, channels sharded over the mesh". Evaluation: the
per-branch FIR is a K-tap shifted-accumulate over the (T, M)
commutator matrix (elementwise), and the cross-branch DFT runs through
the same split-complex FFT wrappers as the demodulator (ops/cfft).

The output of channel m is centred at m·fs/M; feed the channels into
``parallel.build_sharded_demod_step`` (blocks axis = channel) to
demodulate them mesh-parallel.
"""

import jax
import jax.numpy as jnp
import numpy as np

from pycusdr_tpu.ops.cfft import fft_ri


def design_prototype(M: int, taps_per_branch: int = 8, beta: float = 9.0) -> np.ndarray:
    """Kaiser-windowed sinc lowpass, cutoff 1/(2M), length M*taps."""
    L = M * taps_per_branch
    n = np.arange(L) - (L - 1) / 2
    h = np.sinc(n / M) * np.kaiser(L, beta)
    return (h / h.sum()).astype(np.float64)


class Channelizer:
    """Critically sampled M-channel analysis PFB with streaming state."""

    def __init__(self, M: int, taps_per_branch: int = 8, beta: float = 9.0,
                 jit: bool = True):
        self.M = M
        self.K = taps_per_branch
        h = design_prototype(M, taps_per_branch, beta)
        # polyphase decomposition: branch p uses taps h[kM + p]
        self.h2 = h.reshape(self.K, M).astype(np.float32)  # (K, M)
        self._fn = jax.jit(self._apply) if jit else self._apply

    def _apply(self, x_ri: jnp.ndarray, state_ri: jnp.ndarray):
        """x_ri: (2, T*M) split complex; state_ri: (2, K-1, M) carry.

        Returns (y (M, 2, T), new_state)."""
        M, K = self.M, self.K
        T = x_ri.shape[-1] // M
        x = x_ri.reshape(2, T, M)
        xp = jnp.concatenate([state_ri, x], axis=1)  # (2, T+K-1, M)

        h2 = jnp.asarray(self.h2)
        # v[t, p] = sum_k h2[k, p] * xp[t + K-1 - k, p]  (causal FIR)
        v = jnp.zeros((2, T, M), jnp.float32)
        for k in range(K):
            v = v + h2[k][None, None, :] * jax.lax.dynamic_slice_in_dim(
                xp, K - 1 - k, T, axis=1
            )

        # cross-branch DFT: y[m, t] = sum_p v[t, p] e^{-2pi i p m / M}
        Y = fft_ri(jnp.transpose(v, (1, 0, 2)))  # (T, 2, M) over branches
        y = jnp.transpose(Y, (2, 1, 0))  # (M, 2, T)
        new_state = xp[:, T:, :]
        return y, new_state

    def init_state(self) -> np.ndarray:
        return np.zeros((2, self.K - 1, self.M), np.float32)

    def __call__(self, x_ri, state_ri=None):
        if state_ri is None:
            state_ri = self.init_state()
        return self._fn(x_ri, state_ri)


def channelize_numpy(x: np.ndarray, M: int, taps_per_branch: int = 8,
                     beta: float = 9.0) -> np.ndarray:
    """Direct numpy reference (golden for tests): same math on complex."""
    h = design_prototype(M, taps_per_branch, beta)
    K = taps_per_branch
    T = len(x) // M
    xp = np.concatenate([np.zeros((K - 1) * M, x.dtype), x[: T * M]])
    xm = xp.reshape(T + K - 1, M)
    h2 = h.reshape(K, M)
    v = np.zeros((T, M), np.complex128)
    for k in range(K):
        v += h2[k][None, :] * xm[K - 1 - k : K - 1 - k + T]
    return np.fft.fft(v, axis=1).T  # (M, T)
