"""Host-side demodulator frontend: owns the jitted block graph, the
overlap-save streaming state, and the cross-block bit alignment.

Capability parity with the reference ``Demodulator`` class
(``demodulator/demodulator_base.py``): same two-phase public API
(``uploadAndFindCarrier`` then ``demodulate``), same overlap-window
bit selection, and a port of the ±1-symbol block-boundary healing logic
(``checkSymbolOverlap``, ``:863-988``). The GPU context/plan/buffer
management collapses into JAX: the whole per-block chain is ONE jitted
graph (see dsp/block.py) with device-resident constants.
"""

import logging

import numpy as np

from pycusdr_tpu.dsp.block import build_process_block
from pycusdr_tpu.dsp.spec import DemodSpec, build_spec
from pycusdr_tpu.models.healing import BlockHealer
from pycusdr_tpu.ops.cfft import c2ri

log = logging.getLogger("pycusdr_tpu." + __name__)

# symbol-overlap healing defaults (reference demodulator_base.py:20-22)
SYMBOL_CHECK_OVERLAP_OFFSET = 20
SYMBOL_CHECK_ERROR_THRESHOLD = 1000
SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED = 10


class Demodulator:
    """One Rx channel: streaming state + jitted block graph."""

    def __init__(self, conf, protocol, radioName, spec: DemodSpec = None, jit: bool = True):
        self.protocol = protocol
        self.radioName = radioName
        self.conf = conf
        self.spec = spec if spec is not None else build_spec(conf, protocol, radioName)

        confRadio = conf["Radios"]["Rx"][radioName]
        confGPU = conf["GPU"][confRadio["CUDA_settings"]]
        self.overlapOffset = confGPU.get("symbol_check_overlap_offset", SYMBOL_CHECK_OVERLAP_OFFSET)
        self.symbol_check_error_threshold = confGPU.get(
            "symbol_check_error_threshold", SYMBOL_CHECK_ERROR_THRESHOLD
        )
        self.symbol_check_match_threshold = self.overlapOffset - confGPU.get(
            "symbol_check_match_num_errors_allowed", SYMBOL_CHECK_MATCH_NUM_ERRORS_ALLOWED
        )

        self.Nfft = self.spec.Nfft
        self.sigOverlap = self.spec.sigOverlap
        self.sigOverlapWin = self.spec.sigOverlap // 2
        self.voteWeight = self.spec.voteWeight

        # single-block dispatches take the latency-mode graph; the
        # vmapped backlog graphs (self._batched) keep the batch form.
        # packed=True: ONE device->host transfer per block instead of
        # one per result leaf (see dsp.block.pack_block_outputs)
        self._process_block = build_process_block(self.spec, jit=jit,
                                                  latency_mode=True,
                                                  packed=True)
        self.healer = BlockHealer(
            self.Nfft, self.sigOverlap,
            overlapOffset=self.overlapOffset,
            error_threshold=self.symbol_check_error_threshold,
            match_num_errors_allowed=self.overlapOffset - self.symbol_check_match_threshold,
        )
        self._batched = {}  # batch size -> jitted vmapped graph
        self._capture_fn = None  # lazy whole-capture processor
        try:
            from pycusdr_tpu.native import c2ri_native as _c2ri
        except Exception:
            _c2ri = c2ri
        self._c2ri = _c2ri
        self._signal_buffer = np.zeros(self.Nfft, dtype=np.complex64)
        self._last = None  # device results of the current block

        self.dopplerIdxlast = 0
        self.clippedPeakIPure = np.array([], dtype=np.int64)

        # debug full-state dumps (reference STORE_BITS_IN_FILE,
        # demodulator_base.py:224-241): one npz per block
        from pycusdr_tpu.globals import STORE_BITS_IN_FILE

        self._store_bits = STORE_BITS_IN_FILE
        self._dump_count = 0

        log.info(
            "[%s]: demodulator ready: Nfft=%d overlap=%d masks=%d dopplers=%d "
            "sum_all_masks=%s doppler_search=%s",
            radioName,
            self.Nfft,
            self.sigOverlap,
            self.spec.num_masks,
            self.spec.num_dopplers,
            self.spec.sum_all_masks,
            self.spec.doppler_search,
        )

    # ---------------- reference-parity public API ----------------

    def get_signalBufferHostPointer(self):
        """Host staging buffer for the overlap-save block (the reference
        exposes pinned zero-copy memory; here it's the host array the
        runtime fills before each process call)."""
        return self._signal_buffer

    def warmup(self):
        """Compile AND execute the single-block graph on a zeros block
        without touching any streaming state (healer, staging buffer,
        Doppler memory). The streaming runtime calls this BEFORE
        subscribing to the sample feed so the first compile can never
        accumulate ZMQ backlog behind it (a modem restart mid-pass would
        lose the bursts that arrived while the child compiled)."""
        handle = self._process_block(self._c2ri(
            np.zeros(self.Nfft, np.complex64)))
        np.asarray(handle)  # host fetch: proves device execution

    def dispatch(self, samples=None):
        """Asynchronously dispatch one block's device graph; return an
        opaque handle for ``collect``.

        JAX dispatch is asynchronous: this call returns as soon as the
        graph is enqueued, so the device demodulates this block while the
        host is still post-processing the previous one (or waiting for
        the next hop of samples). The input is snapshotted here (the
        complex->split conversion copies), so the caller may overwrite
        its buffer immediately. Handles MUST be collected in dispatch
        order — the block-boundary healer is sequential host state.
        """
        if samples is None:
            samples = self._signal_buffer
        samples = np.ascontiguousarray(samples, dtype=np.complex64)
        # host boundary: complex64 -> split (2, N) float32 (the device
        # graph is complex-free; see ops/cfft.py). Native deinterleave
        # when the C++ library is built, numpy otherwise.
        return self._process_block(self._c2ri(samples))

    def collect(self, handle):
        """Fetch a ``dispatch`` handle's results and run the host-side
        phase (overlap-window selection + block healing). Returns the
        same dict as ``process``. Blocks until the device has executed
        the dispatched graph."""
        freqOffset, sdev, _clipped, snr = self._fetch(handle)
        bits, centres, trust, spSym = self.demodulate()
        return {
            "bits": bits,
            "trust": trust,
            "centres": centres,
            "spSymEst": spSym,
            "doppler": freqOffset,
            "doppler_std": sdev,
            "SNR": snr,
        }

    def uploadAndFindCarrier(self, samples=None):
        """Run the device graph; return (freqOffset_Hz, sdev_Hz, clippedPeaks, SNR)."""
        return self._fetch(self.dispatch(samples))

    def _fetch(self, handle):
        # ONE device->host transfer: the device graph returns a packed
        # f32 vector (dict handles still accepted — the BER-delta
        # harness swaps in a numpy reference arm that returns dicts)
        if isinstance(handle, dict):
            self._last = {k: np.asarray(v) for k, v in handle.items()}
        else:
            from pycusdr_tpu.dsp.block import unpack_block_outputs

            self._last = unpack_block_outputs(np.asarray(handle), self.spec)
        r = self._last

        if not self.spec.doppler_search:
            self.clippedPeakIPure = np.array([], dtype=np.int64)
            return 0.0, 0.0, self.clippedPeakIPure, 0.0

        freqOffset = float(r["freq_offset_hz"])
        # the reference's second slot carries the match quality scaled to Hz
        sdev_hz = float(r["quality_db"]) / self.Nfft * self.spec.sampleRate
        snr = float(r["snr_db"])
        self.dopplerIdxlast = int(r["shift"])
        return freqOffset, sdev_hz, self.clippedPeakIPure, snr

    def demodulate(self):
        """Return (dataBits, centres, trust, spSymEst) for the non-overlap window."""
        r = self._last
        if r is None:
            raise RuntimeError("call uploadAndFindCarrier first")

        nBits = int(r["nBits"])
        bits = r["bits"][:nBits]
        trust = r["trust"][:nBits]
        centres = r["centres"][:nBits]
        spSym = float(r["spSym"])

        noError = int(np.sum(trust == -1))
        centresWin, bitsWin, trustWin, _ = self.checkSymbolOverlap(
            noError, centres, r["symbols"][:nBits], bits, trust
        )
        if self._store_bits:
            import os

            os.makedirs("debug_dumps", exist_ok=True)
            np.savez(
                f"debug_dumps/{self.radioName}_block{self._dump_count:06d}.npz",
                bits=bits, trust=trust, centres=centres, spSym=spSym,
                doppler_hz=r["doppler_hz"], snr_db=r["snr_db"], E=r["E"],
            )
            self._dump_count += 1
        return bitsWin.astype(np.uint8), centresWin, trustWin.astype(np.int8), spSym

    def processMany(self, hops):
        """Batched streaming: demodulate K consecutive hops in ONE device
        dispatch (vmapped graph), then apply the sequential host-side
        block healing per block.

        ``hops``: (K, Nfft - sigOverlap) complex64 of NEW samples. The
        overlap-save history is taken from (and left in) the staging
        buffer, so interleaving processMany with the per-block API is
        safe. Returns a list of K result dicts like ``process``.

        Batching amortizes the per-dispatch latency over the batch.
        """
        hops = np.ascontiguousarray(hops, dtype=np.complex64)
        K, hop = hops.shape
        if hop != self.Nfft - self.sigOverlap:
            raise ValueError(f"hop must be {self.Nfft - self.sigOverlap}, got {hop}")

        # host-side overlap-save assembly: block i = [tail(i-1), hop_i].
        # At-rest convention (same as the per-block API): the staging
        # buffer's FIRST sigOverlap samples hold the previous tail.
        blocks = np.empty((K, self.Nfft), np.complex64)
        tail = self._signal_buffer[: self.sigOverlap].copy()
        for i in range(K):
            blocks[i, : self.sigOverlap] = tail
            blocks[i, self.sigOverlap :] = hops[i]
            tail = blocks[i, -self.sigOverlap :]
        self._signal_buffer[: self.sigOverlap] = tail

        fn = self._batched.get(K)
        if fn is None:
            from pycusdr_tpu.dsp.block import build_process_batch

            # chunk-evaluated for large K (see dsp.block.BATCH_CHUNK)
            fn = build_process_batch(self.spec, jit=True, packed=True)
            self._batched[K] = fn

        ri = np.stack([self._c2ri(b) for b in blocks])
        res = np.asarray(fn(ri))  # (K, L) — one transfer for the batch

        return [self._emit_packed_row(res[i]) for i in range(K)]

    def _emit_packed_row(self, vec_row):
        """One packed result row -> the healed per-block result dict
        (the SINGLE implementation of the unpack + Doppler stats +
        healing sequence, shared by processMany / processCapture so the
        batched, capture, and streaming paths cannot diverge)."""
        from pycusdr_tpu.dsp.block import unpack_block_outputs

        self._last = unpack_block_outputs(vec_row, self.spec)
        r = self._last
        if self.spec.doppler_search:
            freqOffset = float(r["freq_offset_hz"])
            sdev = float(r["quality_db"]) / self.Nfft * self.spec.sampleRate
            snr = float(r["snr_db"])
            self.dopplerIdxlast = int(r["shift"])
        else:
            freqOffset = sdev = snr = 0.0
        bits, centres, trust, spSym = self.demodulate()
        return {
            "bits": bits, "trust": trust, "centres": centres,
            "spSymEst": spSym, "doppler": freqOffset,
            "doppler_std": sdev, "SNR": snr,
        }

    def process(self, samples=None):
        """Single-call convenience API: both phases + the stats bundle."""
        return self.collect(self.dispatch(samples))

    def processCapture(self, capture, max_hops_per_dispatch=64):
        """Offline pass reprocessing: demodulate a whole recorded capture
        at batch throughput (``dsp.block.build_process_capture`` —
        device-side strided framing + chunk-evaluated batches). The
        sequential host-side block healing is applied per block exactly
        like the streaming path, so the bit stream matches what live
        streaming of the same samples would produce.

        ``capture``: 1-D complex64 array of ANY length; it is padded
        with zeros to whole hops (the trailing partial hop demodulates
        against silence, matching how a live stream ends). The
        overlap-save history enters from (and is left in) the staging
        buffer, so live streaming may resume afterwards. Returns a list
        of per-block result dicts like ``process``.
        """
        import jax.numpy as jnp

        from pycusdr_tpu.dsp.block import build_process_capture

        capture = np.ascontiguousarray(capture, dtype=np.complex64)
        hop = self.Nfft - self.sigOverlap
        K_total = -(-len(capture) // hop)
        if K_total == 0:
            return []
        padded = np.zeros(K_total * hop, np.complex64)
        padded[: len(capture)] = capture

        fn = self._capture_fn
        if fn is None:
            packed = build_process_capture(self.spec, jit=False)

            def packed_capture(hops_ri, carry_ri):
                from pycusdr_tpu.dsp.block import pack_block_outputs

                res, carry = packed(hops_ri, carry_ri)
                res["E"] = jnp.zeros(
                    res["bits"].shape[:1] + (self.spec.D, self.spec.num_masks),
                    jnp.float32)
                return pack_block_outputs(res, self.spec), carry

            import jax

            fn = self._capture_fn = jax.jit(packed_capture)

        out = []
        carry = self._c2ri(self._signal_buffer[: self.sigOverlap])
        # Dispatch in POWER-OF-TWO sub-chunks <= the caller's cap
        # a raw tail K would jit-compile a fresh graph for EVERY
        # distinct capture-length remainder (each compile takes seconds,
        # and the per-shape executable cache grows RSS), while
        # zero-hop SHAPE PADDING mid-capture would corrupt the device
        # carry chain (the carry after a padded dispatch reflects the
        # padding, not the real previous samples). Decomposing every
        # remainder into power-of-two dispatches bounds the compiled
        # shape set to {1, 2, 4, ..., P} with NO padding: the device
        # carry chain stays exact end to end and no dispatch ever
        # exceeds the caller's memory cap.
        P = 1 << (max(1, int(max_hops_per_dispatch)).bit_length() - 1)
        pos = 0
        pending = None  # (device results, row count) of the previous dispatch
        while pos < K_total:
            rem = K_total - pos
            K = P if rem >= P else 1 << (rem.bit_length() - 1)
            hops = padded[(pos) * hop : (pos + K) * hop].reshape(K, hop)
            hops_ri = np.stack([self._c2ri(h) for h in hops])
            # depth-1 software pipeline: dispatch chunk k+1 BEFORE
            # fetching chunk k's results. The overlap-save carry chains
            # DEVICE-SIDE (fn's returned carry feeds the next dispatch
            # without a host sync), so chunk k+1's host->device upload
            # (~33 MB at the flagship shape) and its execution overlap
            # chunk k's result fetch. Emission order (and the
            # sequential host-side healer) is unchanged.
            vec, carry = fn(hops_ri, carry)
            if pending is not None:
                pv, pk = pending
                pv = np.asarray(pv)  # ONE transfer per dispatch
                out.extend(self._emit_packed_row(pv[i]) for i in range(pk))
            pending = (vec, K)
            pos += K
        pv, pk = pending
        pv = np.asarray(pv)
        out.extend(self._emit_packed_row(pv[i]) for i in range(pk))
        # leave the overlap-save history where live streaming expects it
        tail = np.asarray(carry)
        self._signal_buffer[: self.sigOverlap] = (
            tail[0] + 1j * tail[1]).astype(np.complex64)
        return out

    # ---------------- block-boundary healing ----------------

    def checkSymbolOverlap(self, noError, centres, idxSymbol, dataBits, trustSymbol):
        """±1-symbol block-boundary alignment; see models/healing.py
        (port of reference demodulator_base.py:863-988)."""
        return self.healer.heal(noError, centres, idxSymbol, dataBits, trustSymbol)
