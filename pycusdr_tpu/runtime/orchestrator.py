"""The orchestrator: wire up and supervise the whole modem.

Capability parity with the reference ``PyCuSDR`` class
(``pyCuSDR/pyCuSDR.py:44-346``): modular-JSON config load, per-name
protocol instantiation, modulators / softCombiner / demodulators /
decoder / RPC construction (with the softCombiner bypass rewiring
``decodeIn = demodIn`` when disabled or single-radio), a watchdog
``is_alive`` that ends the run when any process dies or every
demodulator lost its sample feed, and an ordered shutdown that collects
the decoder's stats for post-pass plots.
"""

import logging
import os
import sys
import time

from pycusdr_tpu import __version__
from pycusdr_tpu.config.loader import load_modular_json
from pycusdr_tpu.globals import LOG_NAME
from pycusdr_tpu.protocol import loadProtocol
from pycusdr_tpu.utils.graceful import GracefulKiller
from pycusdr_tpu.utils.logger import logger_setup

log = logging.getLogger(LOG_NAME + "." + __name__)


def demod_memory_fraction(n_resident):
    """Share of one card's memory for each of ``n_resident`` demod
    children held on it at once (``XLA_PYTHON_CLIENT_MEM_FRACTION``).
    A JAX client reserves three quarters of the card when it starts, so
    a second child would fail for want of memory; None leaves a lone
    child JAX's default."""
    if n_resident <= 1:
        return None
    return 0.9 / n_resident


class PyCuSDR:
    """Top-level API: ``PyCuSDR(configFile, args).start() / run()``."""

    def __init__(self, config_file_name, args=None):
        self.start_time = time.time()
        self.args = args
        if isinstance(config_file_name, dict):
            self.configFile = config_file_name
        else:
            log.info("Loading configuration from %s", config_file_name)
            self.configFile = load_modular_json(config_file_name)

        self._init_logging()
        log.info("Starting pycusdr_tpu %s", __version__)

        self._init_protocols()
        self.radios = self.configFile["Radios"]["Rx"].keys()
        self._restart_enabled = self.configFile["Main"].get("restartDeadProcesses", False)
        self._max_restarts = self.configFile["Main"].get("maxProcessRestarts", 3)
        self._restarts = 0
        # planned-maintenance restart when a worker's RSS exceeds this
        # cap (MB; 0 = off): bounds a worker whose host memory grows
        # over a long pass (bench/hw_leak_probe.py measures the demod
        # child's RSS). The demod child compiles before subscribing, so
        # a restart loses only the (re)compile window of samples.
        self._max_rss_mb = self.configFile["Main"].get("maxWorkerRssMb", 0)
        self._last_rss_check = 0.0
        import threading

        # restarts may be triggered from is_alive() (a polling caller)
        # or the maintenance thread below — serialize them
        self._maint_lock = threading.Lock()
        self._maint_thread = None
        # task objects currently being torn down by a PLANNED restart:
        # a concurrent is_alive() poll must not read their dead state as
        # a crash (with restartDeadProcesses off it would raise and
        # abort the pass the cap exists to protect)
        self._maint_restarting = set()
        self._rss_restart_at = {}  # task index -> last planned-restart time
        self._restart_seq = 0  # workerId suffix for replacement children
        self._init_SDR()
        self._running = False
        self.killer = None

    # ---------------- lifecycle ----------------

    def start(self):
        self._running = True
        for t in self.tasks:
            t.start()
        self.killer = GracefulKiller()
        if self._max_rss_mb:
            # the RSS cap must fire even for embedders that never poll
            # is_alive() (the reference API contract is caller-polls; a
            # cap that silently depends on that is a footgun — found by
            # the first capped-soak run, where the child sailed to 13 GB
            # because the harness drove its own recv loop)
            import threading

            def maint():
                while self._running:
                    try:
                        self._check_rss_caps()
                    except Exception:
                        log.exception("RSS maintenance check failed")
                    time.sleep(2.0)

            self._maint_thread = threading.Thread(target=maint, daemon=True)
            self._maint_thread.start()

    def is_alive(self):
        """False when killed, every demod timed out, or a process died.

        With ``Main.restartDeadProcesses`` a crashed worker is rebuilt
        from its factory and restarted (up to ``maxProcessRestarts``
        times) instead of aborting the pass — elastic recovery the
        reference does not have (its watchdog always aborts,
        pyCuSDR.py:112-115)."""
        if self.killer is not None and self.killer.kill_now:
            log.debug("killed")
            return False
        # a planned restart's stop() clears the child's runStatus, which
        # makes its SigFIFO raise TimeoutError("Terminated") and set the
        # GRC-timeout flag during teardown — that is shutdown signalling,
        # not a lost sample feed, so exclude mid-restart children here
        active = [d for d in self._demodulators
                  if id(d) not in self._maint_restarting]
        if active and all(d.GRCTimeout() for d in active):
            log.debug("all demodulators timed out")
            return False
        for i, t in enumerate(self.tasks):
            time.sleep(0.1)
            if not t.is_alive():
                if id(t) in self._maint_restarting or self.tasks[i] is not t:
                    continue  # planned restart in progress / already replaced
                if (self._restart_enabled
                        and self._restarts < self._max_restarts
                        and self._task_factories[i] is not None):
                    # non-blocking: the maintenance thread can hold the
                    # lock across a make-before-break restart (warm wait
                    # + overlap, tens of seconds) — a real-time poller
                    # must not stall here; the dead task is retried on
                    # the next poll once the lock frees
                    if not self._maint_lock.acquire(blocking=False):
                        continue
                    try:
                        if self.tasks[i] is not t:
                            continue  # the maintenance thread already replaced it
                        self._restarts += 1
                        log.error("Process %s died -- restarting (%d/%d)",
                                  t.name, self._restarts, self._max_restarts)
                        new_t = self._task_factories[i]()
                        self._replace_task(i, t, new_t)
                        new_t.start()
                    finally:
                        self._maint_lock.release()
                    continue
                raise Exception(f"Process {t.name} died unexpectedly -- shutting down")
        self._check_rss_caps()
        return True

    def _check_rss_caps(self):
        """Planned-maintenance restart of any worker whose RSS exceeds
        ``Main.maxWorkerRssMb`` (see __init__ note; at most one restart
        per check so the pipeline never loses every stage at once)."""
        if not self._max_rss_mb or not self._running:
            return
        # non-blocking: during a planned restart the maintenance thread
        # holds the lock across stop/terminate/join (up to ~20 s) — a
        # real-time is_alive() poller must not stall for that window.
        # The 10 s throttle tolerates skipped checks.
        if not self._maint_lock.acquire(blocking=False):
            return
        try:
            self._check_rss_caps_locked()
        finally:
            self._maint_lock.release()

    def _check_rss_caps_locked(self):
        now = time.time()
        if now - self._last_rss_check < 10.0:
            return
        self._last_rss_check = now
        import psutil

        for i, t in enumerate(self.tasks):
            pid = getattr(t, "pid", None)
            if not pid or self._task_factories[i] is None:
                continue
            try:
                rss_mb = psutil.Process(pid).memory_info().rss / 1e6
            except Exception:
                continue
            if rss_mb <= self._max_rss_mb:
                continue
            # storm guard: if a task trips the cap again within one
            # cooldown of its last planned restart, the cap is below
            # the worker's BASELINE footprint (a fresh JAX child is
            # ~1-2 GB before any leak) — a kill/compile/kill loop would
            # decode nothing. Disable the cap and say so, loudly.
            last = self._rss_restart_at.get(i, 0.0)
            if time.time() - last < 120.0:
                log.error(
                    "Process %s exceeds maxWorkerRssMb=%d MB immediately "
                    "after a planned restart (baseline footprint above the "
                    "cap) -- disabling the RSS cap; raise it above the "
                    "worker's warm RSS", t.name, self._max_rss_mb)
                self._max_rss_mb = 0
                return
            log.warning("Process %s RSS %.0f MB exceeds cap %d MB -- "
                        "planned restart", t.name, rss_mb, self._max_rss_mb)
            self._maint_restarting.add(id(t))
            try:
                # MAKE-BEFORE-BREAK when the worker supports it (the
                # demod child exposes warmedFlag/subscribeGate): start
                # the replacement and let it compile/warm while the OLD
                # child keeps decoding; only then tear the old one down
                # and release the new child to subscribe. The decode gap
                # shrinks from the compile window (~17-77 s) to the
                # socket switchover (~1-2 s).
                new_t = None
                # gate capability is a class property: probe the task
                # being replaced instead of building (and discarding) a
                # throwaway factory instance for gate-less workers
                if hasattr(t, "warmedFlag") and hasattr(t, "subscribeGate"):
                    new_t = self._task_factories[i]()
                    # distinguishable stream identity: the decoder keys
                    # its frame-finder continuation state AND duplicate
                    # suppression by workerId, so the overlap window
                    # (below) must not interleave two children into one
                    # bit stream
                    if hasattr(new_t, "workerId"):
                        self._restart_seq += 1
                        new_t.workerId = f"{new_t.workerId}~r{self._restart_seq}"
                    new_t.subscribeGate.clear()
                    new_t.start()
                    deadline2 = time.time() + 300.0
                    while (time.time() < deadline2 and self._running
                           and new_t.is_alive()
                           and not new_t.warmedFlag.wait(0.5)):
                        pass
                    if not new_t.is_alive():
                        # the replacement crashed during compile/warm
                        # (OOM from double residency, backend error):
                        # keep the healthy old child out of the swap
                        # path and fall back to break-before-make below
                        log.error("replacement %s died during warm-up -- "
                                  "falling back to break-before-make",
                                  new_t.name)
                        new_t = None
                    elif not new_t.warmedFlag.is_set():
                        log.error(
                            "replacement %s not warm yet -- swapping "
                            "anyway (it will subscribe when ready)",
                            new_t.name)
                    if new_t is not None:
                        # ZERO-GAP switchover: the sample feed is
                        # PUB/SUB, so the replacement subscribes WHILE
                        # the old child still decodes; both see every
                        # sample for the overlap window (any burst in
                        # flight at either edge is fully inside one
                        # child's stream), then the old child is torn
                        # down. Duplicate decodes during the overlap
                        # carry the suffixed workerId — a separate
                        # decoder stream, deduplicated by the
                        # packet-hash history
                        # (decoder.packetCheckHistTimeout).
                        new_t.subscribeGate.set()
                        overlap = float(self.configFile["Main"].get(
                            "restartOverlapSeconds", 5.0))
                        t_end = time.time() + overlap
                        while time.time() < t_end and self._running:
                            time.sleep(0.1)
                # gate-less workers (decoder, combiner, ...) take the
                # break-before-make path below: teardown first, then
                # one factory build
                t.stop()
                deadline = time.time() + 5.0
                while t.is_alive() and time.time() < deadline:
                    time.sleep(0.1)
                t.terminate()
                # the demod child masks SIGTERM during run() (reference
                # parity) and can be blocked in a device fetch — never
                # hold _maint_lock on an unbounded join
                # (is_alive() and _shutdown() both wait on this lock)
                t.join(timeout=10.0)
                if t.is_alive() and pid:
                    import signal as _sig

                    log.error("Process %s ignored terminate; SIGKILL %d",
                              t.name, pid)
                    try:
                        os.kill(pid, _sig.SIGKILL)
                    except OSError:
                        pass
                    t.join(timeout=5.0)
                if new_t is not None:
                    # old child is down; the replacement took over
                    # during the overlap window above
                    self._replace_task(i, t, new_t)
                else:
                    new_t = self._task_factories[i]()
                    self._replace_task(i, t, new_t)
                    new_t.start()
            finally:
                # storm-guard stamp AFTER the restart completes: the
                # make-before-break path can itself take longer than
                # the 120 s guard window (cold compile + overlap), and
                # a pre-restart stamp would let a baseline-above-cap
                # loop evade the guard forever
                self._rss_restart_at[i] = time.time()
                self._maint_restarting.discard(id(t))
            return

    def _replace_task(self, i, old, new):
        self.tasks[i] = new
        for coll in (self._demodulators, self._modulators):
            for j, x in enumerate(coll):
                if x is old:
                    coll[j] = new
        if old is self.dec:
            self.dec = new
        if getattr(self, "combiner", None) is old:
            self.combiner = new
            if self.rpcInt is not None:
                self.rpcInt.softCombiner = new
        # keep the RPC thread pointed at live processes
        if self.rpcInt is not None:
            if isinstance(self.rpcInt.demodulator, list):
                for j, x in enumerate(self.rpcInt.demodulator):
                    if x is old:
                        self.rpcInt.demodulator[j] = new
            for k, v in list(getattr(self.rpcInt, "modulator", {}).items()):
                if v is old:
                    self.rpcInt.modulator[k] = new

    def run(self):
        try:
            self.start()
            while self.is_alive():
                time.sleep(0.1)
        except SystemExit:
            log.error("SYSTEMEXIT")
        except Exception as e:
            log.error("Error in process")
            log.exception(e)
        finally:
            self.terminate()

    def terminate(self):
        self._shutdown()

    def shutdown_tasks(self):
        """Hook run during shutdown, before force-terminating: collect
        the decoder stats and write post-pass analytics."""
        self._running = False
        try:
            plotData = self.dec.getVisualData()
            if plotData:
                from pycusdr_tpu.obs import stats

                saveLoc = stats.processData(self.configFile, plotData, self.start_time)
                log.info("Saved pass stats to %s", saveLoc)
        except Exception as e:
            log.error("could not generate stats")
            log.exception(e)

    def _shutdown(self):
        log.info("Shutting down")
        # stop the maintenance thread FIRST: an RSS check racing the
        # shutdown would restart a task that is being stopped
        self._running = False
        with self._maint_lock:
            pass  # wait out any in-flight restart
        for t in self.tasks:
            t.stop()
        self.shutdown_tasks()
        if self.rpcInt is not None:
            self.rpcInt.terminate()

        TIMEOUT = 5
        start = time.time()
        while time.time() - start <= TIMEOUT:
            if any(t.is_alive() for t in self.tasks):
                time.sleep(0.1)
            else:
                break
        for t in self.tasks:
            t.terminate()
            t.join()
        if self.rpcInt is not None:
            self.rpcInt.join()
        log.info("Finished -- Bye")
        from pycusdr_tpu.utils.logger import shutdown_logging

        shutdown_logging()

    # ---------------- construction ----------------

    def _init_SDR(self):
        from pycusdr_tpu.combine import SoftCombiner
        from pycusdr_tpu.runtime.decoder_process import Decoder
        from pycusdr_tpu.runtime.demodulator_process import Demodulator_process
        from pycusdr_tpu.runtime.modulator_process import Modulator_process

        try:
            log.info("Utilizing %d channels: %s", len(self.radios), ", ".join(self.radios))
            self.tasks = tasks = []
            # one factory per task (same index) so a crashed worker can
            # be rebuilt when restartDeadProcesses is enabled
            self._task_factories = factories = []

            # Tx modulators (one per Tx radio, protocol from config)
            self._modulators = []
            if "Tx" in self.configFile["Radios"]:
                for m in self.configFile["Radios"]["Tx"].keys():
                    modProtocol = self.configFile["Radios"]["Tx"][m]["Protocol"]
                    mk = (lambda name=m, prot=modProtocol:
                          Modulator_process(self.configFile, self.protocols[prot], name))
                    self._modulators.append(mk())
                    factories.append(mk)
                tasks.extend(self._modulators)
            else:
                log.warning("Modulator not initialized ('Tx' not in config)")

            # softCombiner, or bypass rewiring decodeIn = demodIn
            softCombinerEnabled = self.configFile["Main"].get("softCombiner_enabled", False)
            if softCombinerEnabled and len(self.radios) > 1:
                combProc = SoftCombiner(self.configFile)
                tasks.append(combProc)
                factories.append(lambda: SoftCombiner(self.configFile))
                log.info("SoftCombiner initialized.")
            else:
                self.configFile["Interfaces"]["Internal"]["decodeIn"] = \
                    self.configFile["Interfaces"]["Internal"]["demodIn"]
                combProc = None
                log.info("SoftCombiner not started. Sending bits directly to decoder")
            self.combiner = combProc

            # Rx demodulators: one process per channel (reference model),
            # or one lockstep channel-group process demodulating every
            # channel in a single device dispatch + on-device vote
            # (for clock-shared antennas / channelizer outputs; see
            # runtime/channel_group_process.py)
            self._demodulators = []
            groupEnabled = self.configFile["Main"].get("channelGroup_enabled", False)
            if groupEnabled and len(self.radios) > 1:
                from pycusdr_tpu.runtime.channel_group_process import ChannelGroup_process

                rx = self.configFile["Radios"]["Rx"]
                keys = ("Protocol", "baud", "samplesPerSym", "CUDA_settings", "voteGroup")
                first = {k: next(iter(rx.values())).get(k) for k in keys}
                for name, rc in rx.items():
                    for k in keys:
                        if rc.get(k) != first[k]:
                            raise ValueError(
                                f"channelGroup_enabled requires homogeneous Rx radios: "
                                f"{name}.{k}={rc.get(k)!r} differs from {first[k]!r}"
                            )
                protocolName = first["Protocol"]
                mk = (lambda prot=protocolName:
                      ChannelGroup_process(self.configFile, self.protocols[prot],
                                           list(self.radios)))
                self._demodulators.append(mk())
                factories.append(mk)
            else:
                # every per-radio child shares the one card, and a
                # planned restart holds a replacement beside its old
                # child: give each its share of the card's memory
                resident = len(self.radios) + (1 if self._max_rss_mb else 0)
                self._demod_mem_fraction = demod_memory_fraction(resident)
                for radio in self.radios:
                    protocolName = self.configFile["Radios"]["Rx"][radio]["Protocol"]
                    mk = (lambda r=radio, prot=protocolName:
                          Demodulator_process(self.configFile, self.protocols[prot], r,
                                              memFraction=self._demod_mem_fraction))
                    self._demodulators.append(mk())
                    factories.append(mk)
            tasks.extend(self._demodulators)

            # decoder (kept as attribute: stats are fetched at shutdown)
            self.dec = Decoder(self.configFile, self.protocols)
            tasks.append(self.dec)
            factories.append(lambda: Decoder(self.configFile, self.protocols))

            # control plane
            if self.configFile.get("RPC", {}).get("enabled", True):
                from pycusdr_tpu.control.rpc import RpcInterface

                self.rpcInt = RpcInterface(
                    self.configFile, self._modulators, self._demodulators, combProc
                )
            else:
                self.rpcInt = None
        except Exception as e:
            log.error("Fatal error while initializing:")
            log.exception(e)
            sys.exit(-1)

    def _init_logging(self):
        v = getattr(self.args, "v", 0) if self.args is not None else 0
        logLevel = max(1, 30 - v * 10)
        fileName = self.configFile.get("Main", {}).get("logFile")
        logger_setup(fileName=fileName, logLevel=logLevel)
        self.log = logging.getLogger(LOG_NAME)

    def _init_protocols(self):
        main = self.configFile["Main"]
        if "protocols" not in main:
            raise KeyError('"protocols" not defined in "Main"')
        self.protocols = {}
        self.protocolNamesDict = {}
        for pName, implName in main["protocols"].items():
            self.protocolNamesDict[pName] = implName
            self.protocols[pName] = loadProtocol(implName)(conf=self.configFile)
        log.info("Found protocols %s", self.protocolNamesDict)

    # ---------------- getters ----------------

    @property
    def demodulators(self):
        return self._demodulators

    @property
    def modulators(self):
        return self._modulators
