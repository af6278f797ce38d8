"""Failure detection (SURVEY §5): the orchestrator watchdog must end
the run when a process dies, and end it gracefully when every
demodulator loses its sample feed (GRC-gone)."""

import os
import time

import numpy as np
import pytest

from pycusdr_tpu.config.loader import load_modular_json

CONF_DIR = os.path.join(os.path.dirname(__file__), "..", "pycusdr_tpu", "config", "configs")


def _conf(base_port):
    conf = load_modular_json(os.path.join(CONF_DIR, "benchmark", "bench_FSK.json"))
    conf["Main"].update(workerId="fd", PacketLen=1000)
    conf["GPU"]["UHF"].update(blockSize=13, overlap=10)
    conf["Radios"]["Rx"]["UHF-H"]["doppCarrierSteps"] = 16
    conf["Radios"]["Rx"]["UHF-H"]["Interfaces"] = {
        "RxInPort": f"tcp://127.0.0.1:{base_port}",
        "demodOut": f"tcp://localhost:{base_port + 1}",
    }
    conf["Interfaces"]["Internal"].update({
        "demodIn": f"tcp://*:{base_port + 1}",
        "demodOut": f"tcp://localhost:{base_port + 1}",
        "decodeOut": f"tcp://localhost:{base_port + 2}",
        "decodeIn": f"tcp://*:{base_port + 2}",
    })
    conf["Interfaces"]["External"]["decodeBytesOut_ZMQ"] = {"UHF": f"tcp://*:{base_port + 3}"}
    conf["Interfaces"]["External"]["XMLRpcIn"] = f"127.0.0.1:{base_port + 4}"
    conf["decoder"] = dict(conf.get("decoder", {}), statsPort=base_port + 5)
    return conf


def test_watchdog_detects_dead_process():
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = _conf(31000)
    conf["Demodulator"] = {"timeoutSeconds": 600}
    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        time.sleep(2.0)
        assert sdr.is_alive()
        # SIGKILL: the workers mask SIGTERM by design (the parent
        # coordinates shutdown), so simulate a real crash
        import signal as _sig

        os.kill(sdr.dec.pid, _sig.SIGKILL)
        sdr.dec.join(timeout=5)
        with pytest.raises(Exception, match="died unexpectedly"):
            for _ in range(20):
                if not sdr.is_alive():
                    break
                time.sleep(0.2)
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass


def test_grc_timeout_ends_pass_gracefully():
    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = _conf(31100)
    conf["Demodulator"] = {"timeoutSeconds": 2}  # ~2 s of silence = GRC gone
    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        deadline = time.time() + 60
        alive = True
        while time.time() < deadline:
            alive = sdr.is_alive()
            if not alive:
                break
            time.sleep(0.5)
        assert not alive, "orchestrator did not end after all demods timed out"
        assert all(d.GRCTimeout() for d in sdr.demodulators)
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass


def test_elastic_restart_recovers_decoder():
    """New capability over the reference: with restartDeadProcesses the
    watchdog rebuilds a crashed worker instead of aborting the pass, and
    the pipeline keeps decoding."""
    import signal as _sig

    import zmq

    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.dsp.signal_gen import get_padded_packet, packet_data
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = _conf(31200)
    conf["Main"]["restartDeadProcesses"] = True
    conf["Main"]["maxProcessRestarts"] = 2
    conf["Demodulator"] = {"timeoutSeconds": 600}

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    sig, _ = get_padded_packet("FSK", 16, fs, offset_freq=38400, raw_bits=bits, pad=6000)
    sig = sig.astype(np.complex64)

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:31200")
    sink = ctx.socket(zmq.PULL)
    sink.connect("tcp://localhost:31203")
    sink.setsockopt(zmq.RCVTIMEO, 1500)

    sdr = PyCuSDR(conf, args=None)
    sdr.start()
    try:
        time.sleep(3.0)
        old_pid = sdr.dec.pid
        os.kill(old_pid, _sig.SIGKILL)
        sdr.dec.join(timeout=5)

        # the watchdog must restart it rather than raise
        deadline = time.time() + 20
        while time.time() < deadline:
            assert sdr.is_alive()
            if sdr.dec.pid != old_pid and sdr.dec.is_alive():
                break
            time.sleep(0.2)
        assert sdr.dec.pid != old_pid, "decoder was not restarted"

        # pipeline still decodes after the restart
        time.sleep(2.0)
        step = 2**13 - 2**10
        stream = np.r_[sig, np.zeros(6 * step, np.complex64)]
        payload = None
        for _ in range(15):
            for pos in range(0, len(stream) - step, step):
                pub.send(stream[pos : pos + step].tobytes())
                time.sleep(0.02)
            try:
                payload = sink.recv()
                break
            except zmq.error.Again:
                continue
        assert payload is not None, "no packet decoded after restart"
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass
        pub.close()
        sink.close()
        ctx.term()


def test_rss_cap_planned_restart():
    """Main.maxWorkerRssMb triggers a planned restart of a worker whose
    RSS exceeds the cap (the bound for host-memory growth — see
    bench/hw_leak_probe.py), and the pipeline keeps
    decoding afterwards."""
    import zmq

    os.environ["PYCUSDR_JAX_PLATFORM"] = "cpu"
    from pycusdr_tpu.dsp.signal_gen import get_padded_packet, packet_data
    from pycusdr_tpu.runtime.orchestrator import PyCuSDR

    conf = _conf(31300)
    # every python process exceeds 1 MB, so the demod child (first task
    # with a factory after the modulator-less config) restarts on the
    # first check; maxProcessRestarts is NOT consumed (planned, not
    # crash recovery)
    conf["Main"]["maxWorkerRssMb"] = 1
    conf["Demodulator"] = {"timeoutSeconds": 600}

    bits = packet_data(1000, 123)
    fs = 9600 * 16
    sig, _ = get_padded_packet("FSK", 16, fs, offset_freq=38400,
                               raw_bits=bits, pad=6000)
    sig = sig.astype(np.complex64)

    ctx = zmq.Context()
    pub = ctx.socket(zmq.PUB)
    pub.bind("tcp://127.0.0.1:31300")
    sink = ctx.socket(zmq.PULL)
    sink.connect("tcp://localhost:31303")
    sink.setsockopt(zmq.RCVTIMEO, 1500)

    sdr = PyCuSDR(conf, args=None)
    # avoid a restart storm while we watch: cap back to sane after one
    sdr.start()
    try:
        demod0 = sdr.demodulators[0]
        old_pid = None
        deadline = time.time() + 30
        while time.time() < deadline and old_pid is None:
            assert sdr.is_alive()
            old_pid = demod0.pid
            time.sleep(0.2)
        # wait for the planned restart (RSS check fires every ~10 s)
        deadline = time.time() + 40
        restarted = None
        while time.time() < deadline:
            assert sdr.is_alive()
            cur = sdr.demodulators[0]
            if cur is not demod0 and cur.pid and cur.is_alive():
                restarted = cur
                break
            time.sleep(0.3)
        assert restarted is not None, "no planned restart happened"
        # make-before-break gives the replacement a suffixed workerId so
        # its decoder stream stays distinct during the overlap window
        assert restarted.workerId.endswith("~r1"), restarted.workerId
        # stop further restarts so the decode below can complete
        sdr._max_rss_mb = 10 ** 6

        time.sleep(3.0)  # let the new child warm up (CPU compile)
        step = 2**13 - 2**10
        stream = np.r_[sig, np.zeros(6 * step, np.complex64)]
        payload = None
        for _ in range(15):
            for pos in range(0, len(stream) - step, step):
                pub.send(stream[pos : pos + step].tobytes())
                time.sleep(0.02)
            try:
                payload = sink.recv()
                break
            except zmq.error.Again:
                continue
        assert payload is not None, "no packet decoded after planned restart"
    finally:
        try:
            sdr.terminate()
        except Exception:
            pass
        pub.close()
        sink.close()
        ctx.term()
