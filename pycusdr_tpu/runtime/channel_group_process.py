"""Lockstep multi-channel Rx: one process, one dispatch per block for
a whole vote group, diversity vote on device.

The reference (and our default runtime) runs one OS process + one
device context per Rx channel and votes on the CPU in the softCombiner.
When the channels share a sample clock — co-located antennas on one
digitizer, or the outputs of the polyphase channelizer — they can run
LOCKSTEP: every block, all C channels are assembled into a (C, 2, Nfft)
tensor and demodulated in a single vmapped device dispatch, and the
trust-weighted vote is a device reduction (``parallel.vote``), not a
ZMQ round-trip. Per-channel soft bits are still published (so the
decoder sees each antenna), plus one extra "-voted" stream carrying the
combined bits.

Geographically dispersed, unsynchronised stations keep using the
softCombiner — this path is for the single-station multi-antenna /
wideband case (BASELINE configs #4/#5).

Enable with ``Main.channelGroup_enabled: true`` (orchestrator swaps it
in for the per-radio processes when all Rx radios share one vote
group + identical DSP settings).
"""

import logging
import multiprocessing
import signal
import sys
import time

import numpy as np

_mp = multiprocessing.get_context("spawn")  # owns a JAX context: spawn
Event, Process, Value = _mp.Event, _mp.Process, _mp.Value

log = logging.getLogger("pycusdr_tpu." + __name__)


class ChannelGroup_process(Process):
    def __init__(self, conf, protocol, radios):
        Process.__init__(self)
        self.conf = conf
        self.protocol = protocol
        self.radios = list(radios)
        self.name = "demod-group-" + "+".join(self.radios)

        r0 = conf["Radios"]["Rx"][self.radios[0]]
        self.confGPU = confGPU = conf["GPU"][r0["CUDA_settings"]]
        self.overlap = 2 ** confGPU["overlap"]
        self.blockSize = 2 ** confGPU["blockSize"]
        self.samplesPerSlice = self.blockSize - self.overlap
        self.baudRate = r0["baud"]
        self.spSym = r0["samplesPerSym"]
        self.Fs = float(self.baudRate * self.spSym)
        self.sigFIFOTimeout = conf.get("Demodulator", {}).get("timeoutSeconds", 120)
        self.decoderProtocol = r0.get("Protocol", "None")
        # >=2: keep depth-1 group dispatches in flight (async; results
        # lag that many blocks) — same semantics as the per-radio
        # demodulator process's knob
        self.pipelineDepth = confGPU.get("TPU", {}).get("pipelineDepth", 1)
        self.voteGroup = 0
        self.masterVoteWeight = conf.get("SoftCombiner", {}).get("masterVoteWeight", 1.2)

        self.workerIds = [
            conf["Main"]["workerId"] + "-" + conf["Radios"]["Rx"][r].get("name", r)
            for r in self.radios
        ]
        self.RxInAddrs = [
            conf["Radios"]["Rx"][r]["Interfaces"]["RxInPort"] for r in self.radios
        ]
        self.demodOutAddr = conf["Radios"]["Rx"][self.radios[0]]["Interfaces"].get(
            "demodOut", conf["Interfaces"]["Internal"]["demodOut"]
        )

        self.daemon = True
        self.runStatus = Event()
        self.runStatus.set()
        self.GRCTimeoutFlag = Event()
        self.logLevel = log.getEffectiveLevel()

        # RPC-facing monitored values (group-level)
        self.__SNR = Value("f", 0)
        self.__TxRangeRate = Value("f", 0)
        log.info("[%s]: channel-group process initialized (%d channels)",
                 self.name, len(self.radios))

    def stop(self):
        log.info("PID %s -- received request to stop", self.pid)
        self.runStatus.clear()

    def GRCTimeout(self):
        return self.GRCTimeoutFlag.is_set()

    # minimal monitored-value surface (RPC parity where it matters)
    @property
    def SNR(self):
        with self.__SNR.get_lock():
            v = self.__SNR.value
            self.__SNR.value = 0
        return v

    @SNR.setter
    def SNR(self, v):
        with self.__SNR.get_lock():
            self.__SNR.value = float(v)

    @property
    def TxRangeRate(self):
        return self.__TxRangeRate.value

    @TxRangeRate.setter
    def TxRangeRate(self, v):
        with self.__TxRangeRate.get_lock():
            self.__TxRangeRate.value = float(v)

    # remaining RPC Rx surface (control/rpc.py dereferences these on
    # whatever sits in the demodulator list): group-level scalars
    rangerate = 0.0
    baudRateEst = 0.0
    RxFreqOffset = 0.0
    RxIFFreqOffset = 0.0
    TxIFFreqOffset = 0.0

    @property
    def Fc(self):
        r0 = self.conf["Radios"]["Rx"][self.radios[0]]
        return float(r0["frequency_Hz"] - r0["frequencyOffset_Hz"])

    @property
    def workerId(self):
        return self.workerIds[0]

    def run(self):
        import zmq

        from pycusdr_tpu.globals import apply_platform_override
        from pycusdr_tpu.runtime import sigfifo
        from pycusdr_tpu.utils.logger import child_logger_setup

        child_logger_setup(self.logLevel)
        apply_platform_override()
        time.sleep(0.5)

        import jax

        from pycusdr_tpu.utils.device_info import configure_compile_cache

        configure_compile_cache(self.confGPU.get("TPU", {}).get(
            "compilationCacheDir"))

        from pycusdr_tpu.dsp.block import build_process_block
        from pycusdr_tpu.dsp.spec import build_spec
        from pycusdr_tpu.models.healing import BlockHealer
        from pycusdr_tpu.ops.cfft import c2ri
        from pycusdr_tpu.parallel.vote import vote_n_device

        ctx = zmq.Context()
        demodOut = ctx.socket(zmq.PUSH)
        demodOut.connect(self.demodOutAddr)

        C = len(self.radios)
        fifos = [
            sigfifo.SigFIFO(addr, self.samplesPerSlice, dtype=np.complex64,
                            enableTimeoutException=True,
                            timeoutRetries=self.sigFIFOTimeout,
                            runStatus=self.runStatus)
            for addr in self.RxInAddrs
        ]

        spec = build_spec(self.conf, self.protocol, self.radios[0])
        core = build_process_block(spec, jit=False)
        self._pack_spec = spec
        group_fn = jax.jit(
            lambda blocks: self._group_graph(blocks, core, vote_n_device)
        )
        healers = [BlockHealer(spec.Nfft, spec.sigOverlap) for _ in range(C)]
        healers.append(BlockHealer(spec.Nfft, spec.sigOverlap))  # voted stream

        tails = np.zeros((C, self.overlap), np.complex64)
        count = 0
        self.GRCTimeoutFlag.clear()
        log.info("[%s]: channel-group running (%d lockstep channels)", self.name, C)
        orig_sigterm = signal.getsignal(signal.SIGTERM)
        signal.signal(signal.SIGTERM, lambda *_: None)

        def ship(d):
            try:
                demodOut.send_pyobj(d, zmq.NOBLOCK)
            except zmq.error.Again as e:
                log.error("[%s]: failed to send [%s]", self.name, e)

        from pycusdr_tpu.runtime.pipeline import InflightPipeline

        def emit(handle, cnt, ts):
            """Fetch one in-flight group dispatch; heal + ship its
            C per-channel streams and the device-voted stream. ``ts``
            is the dispatch-time stamp (same meaning as the per-radio
            process: when the signal block was taken, not when its
            results were collected)."""
            from pycusdr_tpu.dsp.block import packed_len, unpack_block_outputs

            vec = np.asarray(handle)  # the ONE transfer
            L = packed_len(spec)
            S = spec.numSymMax
            chans = [unpack_block_outputs(vec[c * L:(c + 1) * L], spec)
                     for c in range(C)]
            bits_voted = vec[C * L: C * L + S]
            trust_voted = vec[C * L + S: C * L + 2 * S]

            snrs = []
            for c, r in enumerate(chans):
                nBits = int(r["nBits"])
                _, bits, trust, _ = healers[c].heal(
                    int(np.sum(r["trust"][:nBits] == -1)),
                    r["centres"][:nBits], r["symbols"][:nBits],
                    r["bits"][:nBits], r["trust"][:nBits],
                )
                snrs.append(float(r["snr_db"]))
                ship({
                    "workerId": self.workerIds[c], "count": cnt,
                    "timestamp": ts, "voteGroup": self.voteGroup,
                    "doppler": float(r["freq_offset_hz"]),
                    "doppler_std": 0.0,
                    "data": bits.astype(np.uint8),
                    "trust": trust.astype(np.int8),
                    "spSymEst": float(r["spSym"]),
                    "SNR": float(r["snr_db"]),
                    "baudRate": self.baudRate, "baudRate_est":
                        self.Fs / max(float(r["spSym"]), 1e-9),
                    "sample_rate": self.Fs,
                    "protocol": self.decoderProtocol,
                    "numSlaves": 0,
                })

            # the device-voted stream (numSlaves = C-1 voters)
            r0 = chans[0]
            nBits = int(r0["nBits"])
            vtrust8 = np.clip(trust_voted[:nBits], -2, 127).astype(np.int8)
            _, vbits, vtrust, _ = healers[-1].heal(
                0, r0["centres"][:nBits], r0["symbols"][:nBits],
                bits_voted[:nBits].astype(np.int8), vtrust8,
            )
            ship({
                "workerId": self.workerIds[0] + "-voted", "count": cnt,
                "timestamp": ts, "voteGroup": self.voteGroup,
                "doppler": float(r0["freq_offset_hz"]),
                "doppler_std": 0.0,
                "data": vbits.astype(np.uint8),
                "trust": vtrust.astype(np.int8),
                "spSymEst": float(r0["spSym"]),
                "SNR": float(np.max(snrs)),
                "baudRate": self.baudRate,
                "baudRate_est": self.Fs / max(float(r0["spSym"]), 1e-9),
                "sample_rate": self.Fs,
                "protocol": self.decoderProtocol,
                "numSlaves": C - 1,
            })
            self.SNR = float(np.max(snrs))

        pipeline = InflightPipeline(self.pipelineDepth, emit)

        try:
            while self.runStatus.is_set():
                try:
                    hops = [f.getBlock() for f in fifos]  # lockstep
                    if self.GRCTimeoutFlag.is_set():
                        self.GRCTimeoutFlag.clear()  # feed recovered
                    blocks = np.concatenate(
                        [tails, np.stack(hops)], axis=1
                    )  # (C, Nfft)
                    tails = blocks[:, -self.overlap :].copy()

                    # async dispatch; depth-1 handles stay in flight so
                    # the device overlaps with healing + the lockstep wait
                    pipeline.push(group_fn(c2ri(blocks)), count, time.time())
                    count += 1
                    if len(pipeline) and any(f.idle() for f in fifos):
                        # feed paused: don't hold computed results back
                        pipeline.flush()
                except (TimeoutError, ConnectionRefusedError):
                    log.info("[%s]: sample feed timed out", self.name)
                    # signal BEFORE flushing: a wedged device fetch must
                    # not mask the feed loss from the watchdog
                    self.GRCTimeoutFlag.set()
                    pipeline.flush()  # feed gone: ship what's computed
                    count = 0
                    # a partial lockstep read consumed hops from some
                    # channels only: flush every ring and zero the
                    # overlap tails so recovery restarts sample-aligned
                    for f in fifos:
                        f.buf.flush()
                    tails[:] = 0
        except Exception as e:
            log.exception(e)
        finally:
            try:
                pipeline.flush()
            except Exception:
                log.exception("failed to flush in-flight group blocks")
            demodOut.close()
            for f in fifos:
                del f
            signal.signal(signal.SIGTERM, orig_sigterm)
            log.info("[%s]: finished", self.name)
            sys.stdout.flush()

    def _group_graph(self, blocks_ri, core, vote_n_device):
        """(C, 2, N) -> vmapped per-channel demod + on-device vote."""
        import jax
        import jax.numpy as jnp

        from pycusdr_tpu.dsp.block import pack_block_outputs

        res = jax.vmap(core)(blocks_ri)
        # pad slots beyond each channel's own bit count must not vote:
        # mark them distrusted before the reduction
        numSymMax = res["trust"].shape[1]
        slot = jnp.arange(numSymMax, dtype=jnp.int32)[None, :]
        trust = jnp.where(slot < res["nBits"][:, None], res["trust"], jnp.int8(-1))
        res["trust"] = trust
        voted, vtrust = vote_n_device(res["bits"], trust,
                                      master_weight=self.masterVoteWeight)
        # ONE device->host transfer per group dispatch (see dsp.block.
        # pack_block_outputs) — (C, L) channel rows + the voted pair
        flat = pack_block_outputs(res, self._pack_spec).reshape(-1)
        return jnp.concatenate([flat, voted.astype(jnp.float32),
                                vtrust.astype(jnp.float32)])
