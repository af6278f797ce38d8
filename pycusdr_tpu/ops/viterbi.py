"""Convolutional coding: CCSDS K=7 rate-1/2 encoder + Viterbi decoder.

New capability over the reference (which ships no convolutional FEC).
The decoder is written array-style: the 64-state trellis lives as a
vector, each time step is one vectorized add-compare-select over
precomputed branch-metric tables, and ``lax.scan`` walks the sequence —
no per-state Python, fully jittable, batchable with ``vmap``. Traceback
runs on the host over the scan's decision bitmap (cheap, O(T)).

Code: G1 = 0o171, G2 = 0o133 (CCSDS 131.0-B; the standard's inversion
of the second symbol is a flag). Supports hard bits or soft LLRs.
"""

import numpy as np

K = 7
N_STATES = 64
G1 = 0o171
G2 = 0o133


def _parity(x: np.ndarray) -> np.ndarray:
    x = x.copy()
    p = np.zeros_like(x)
    while np.any(x):
        p ^= x & 1
        x >>= 1
    return p


def _branch_tables(invert_g2: bool):
    """out0/out1 for every (state, input) pair; state = last 6 bits,
    newest at LSB; register value = (state << 1) | input is wrong order:
    define register r = input bit is the NEWEST, shifting left:
    r = (state << 1) | b, outputs are parities of r & G."""
    s = np.arange(N_STATES)
    r0 = (s << 1) | 0
    r1 = (s << 1) | 1
    o0 = np.stack([_parity(r0 & G1), _parity(r0 & G2)], axis=1)
    o1 = np.stack([_parity(r1 & G1), _parity(r1 & G2)], axis=1)
    if invert_g2:
        o0[:, 1] ^= 1
        o1[:, 1] ^= 1
    return o0.astype(np.int8), o1.astype(np.int8)  # (64, 2) each


def conv_encode(bits, invert_g2: bool = True) -> np.ndarray:
    """Encode with K-1 flush zeros appended; returns 2*(n+6) symbols."""
    bits = np.r_[np.asarray(bits, np.uint8), np.zeros(K - 1, np.uint8)]
    o0, o1 = _branch_tables(invert_g2)
    out = np.empty((len(bits), 2), np.uint8)
    state = 0
    for i, b in enumerate(bits):
        out[i] = (o1 if b else o0)[state]
        state = ((state << 1) | int(b)) & (N_STATES - 1)
    return out.reshape(-1)


def viterbi_decode(symbols, n_bits: int = None, invert_g2: bool = True,
                   soft: bool = False, terminated: bool = True,
                   _return_metric: bool = False):
    """Decode a rate-1/2 stream; ``symbols``: (2T,) hard bits {0,1} or
    soft values (larger = more '1'-like) when ``soft=True``.

    Returns the decoded information bits (flush bits stripped when
    ``n_bits`` is given). The trellis sweep is jitted jnp; traceback is
    host-side numpy.
    """
    import jax
    import jax.numpy as jnp

    sym = np.asarray(symbols, np.float32).reshape(-1, 2)
    T = len(sym)
    o0, o1 = _branch_tables(invert_g2)

    # branch metric of observing (r0, r1) given expected (e0, e1):
    # hard -> Hamming distance; soft -> negative correlation
    e = np.stack([o0, o1], axis=0).astype(np.float32)  # (2, 64, 2)
    if soft:
        sgn = e * 2.0 - 1.0  # ±1

        def metrics(r):
            return -(sgn[..., 0] * r[0] + sgn[..., 1] * r[1])  # (2, 64)
    else:
        def metrics(r):
            return jnp.abs(e[..., 0] - r[0]) + jnp.abs(e[..., 1] - r[1])

    # predecessors of new state ns: pa = ns >> 1, pb = (ns >> 1) | 32;
    # the input bit that produced ns is its LSB
    ns = np.arange(N_STATES)
    pa = (ns >> 1).astype(np.int32)
    pb = ((ns >> 1) | (N_STATES // 2)).astype(np.int32)
    b_in = (ns & 1).astype(np.int32)

    pa_j = jnp.asarray(pa)
    pb_j = jnp.asarray(pb)
    b_j = jnp.asarray(b_in)

    def step(carry, r):
        pm, tot = carry
        bm = metrics(r)  # (2, 64) branch metric per (input, fromstate)
        cand_a = pm[pa_j] + bm[b_j, pa_j]
        cand_b = pm[pb_j] + bm[b_j, pb_j]
        take_b = cand_b < cand_a
        pm_new = jnp.where(take_b, cand_b, cand_a)
        m = pm_new.min()
        # normalize to keep metrics bounded but ACCUMULATE the offset so
        # the total metric stays meaningful (node-sync discriminant)
        return (pm_new - m, tot + m), take_b

    @jax.jit
    def sweep(rs):
        # terminated frames start at the all-zeros encoder state; a
        # mid-stream entry (streaming) has unknown state -> uniform
        if terminated:
            pm0 = jnp.full((N_STATES,), 1e6, jnp.float32).at[0].set(0.0)
        else:
            pm0 = jnp.zeros((N_STATES,), jnp.float32)
        (pm, tot), decisions = jax.lax.scan(step, (pm0, jnp.float32(0.0)), rs)
        return pm, tot, decisions

    pm, tot, decisions = sweep(jnp.asarray(sym))
    pm = np.asarray(pm)
    if _return_metric:
        return float(tot) + float(pm.min())
    decisions = np.asarray(decisions)  # (T, 64) bool: predecessor was pb

    # traceback from the flushed all-zeros state (terminated) or from
    # the best-metric state (streaming)
    state = 0 if terminated else int(np.argmin(pm))
    bits = np.empty(T, np.uint8)
    for t in range(T - 1, -1, -1):
        bits[t] = state & 1
        state = pb[state] if decisions[t, state] else pa[state]
    if n_bits is not None:
        bits = bits[:n_bits]
    elif T > K - 1:
        bits = bits[: T - (K - 1)]
    return bits


class ViterbiStream:
    """Streaming Viterbi with overlap-discard margins and node sync.

    Feed arbitrary chunks of rate-1/2 symbols; get back the decoded bit
    stream (delayed by the traceback margin). Each call re-decodes a
    ``2*(Dl+Dh)``-symbol tail of history so block seams have full left
    and right context — no per-block edge errors. Node sync (the even/
    odd pairing of symbols) is chosen and re-checked per call from the
    normalized path-metric growth; a clearly better alternative parity
    triggers a resync.
    """

    def __init__(self, invert_g2: bool = True, soft: bool = False,
                 Dl: int = 64, Dh: int = 64):
        self.invert_g2 = invert_g2
        self.soft = soft
        self.Dl = Dl
        self.Dh = Dh
        self.carry = np.zeros(0, np.float32)  # undecided symbol tail
        self.pending = np.zeros(0, np.float32)  # odd leftover symbol
        self.parity = None

    def _decode(self, buf):
        return viterbi_decode(buf, n_bits=len(buf) // 2,
                              invert_g2=self.invert_g2, soft=self.soft,
                              terminated=False)

    def _metric_rate(self, buf):
        if len(buf) < 8:
            return np.inf
        m = viterbi_decode(buf, invert_g2=self.invert_g2, soft=self.soft,
                           terminated=False, _return_metric=True)
        return m / (len(buf) // 2)

    def feed(self, symbols) -> np.ndarray:
        symbols = np.asarray(symbols, np.float32)
        stream = np.r_[self.pending, symbols]

        # node sync: after the first chunk the local stream is already
        # pair-aligned (``pending`` preserves alignment), so r0 is the
        # CURRENT pairing and r1 the shift-by-one alternative — the
        # global parity flag only records the cumulative shift
        shift = 0
        if len(stream) >= 64:
            r0 = self._metric_rate(stream[: len(stream) // 2 * 2])
            r1 = self._metric_rate(stream[1 : 1 + (len(stream) - 1) // 2 * 2])
            if self.parity is None:
                self.parity = 0 if r0 <= r1 else 1
                shift = self.parity
            elif r1 + 0.15 * (abs(r0) + abs(r1)) / 2 + 0.02 < r0:
                # margin form works for hard (positive Hamming rate) and
                # soft (negative correlation rate) metrics alike
                self.parity ^= 1
                self.carry = np.zeros(0, np.float32)  # resync
                shift = 1
        elif self.parity is None:
            self.parity = 0

        stream = stream[shift:] if shift else stream
        usable = len(stream) // 2 * 2
        self.pending = stream[usable:]
        syms = stream[:usable]

        n_prev = len(self.carry) // 2
        buf = np.r_[self.carry, syms]
        if len(buf) < 4:
            self.carry = buf
            return np.zeros(0, np.uint8)

        bits = self._decode(buf)
        n = len(bits)
        start = max(n_prev - self.Dh, 0)
        end = max(n - self.Dh, start)
        out = bits[start:end]

        keep = 2 * (self.Dl + self.Dh)
        self.carry = buf[-keep:] if len(buf) > keep else buf
        return out.astype(np.uint8)
