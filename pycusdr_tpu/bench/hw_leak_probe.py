"""Host->device transfer-leak isolation probe.

Measures whether a process that dispatches the block graph grows in
host memory (RSS) per block, and isolates where:

* ``np_input``           — dispatch the jitted graph on a fresh numpy
                           block each call (what streaming does);
* ``reused_device_input``— same graph, ONE device-resident input reused;
* ``deleted_device_input``— explicit ``device_put`` + ``.delete()``;
* ``tiny_jit``           — a minimal ``jit(lambda a: (a*2).sum())``
                           on the same numpy block (rules our graph out).

A flat RSS in every mode means a long pass needs no bound; a growing
``np_input`` with a flat ``reused_device_input`` points at the client's
host->device transfers, and ``Main.maxWorkerRssMb`` (planned
demod-child restart; see runtime/orchestrator.py) bounds it.

Run:  python -m pycusdr_tpu.bench.hw_leak_probe [--iters 200]
"""

import argparse
import json
import os


def rss_mb():
    import psutil

    return psutil.Process(os.getpid()).memory_info().rss / 1e6


def probe(name, body, iters):
    body()  # settle / compile
    r0 = rss_mb()
    for _ in range(iters):
        body()
    kb = (rss_mb() - r0) / iters * 1000
    print(json.dumps({"probe": name, "kb_per_iter": round(kb, 1)}), flush=True)
    return kb


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=200)
    args = ap.parse_args()

    import jax
    import numpy as np

    from __graft_entry__ import flagship_spec
    from pycusdr_tpu.dsp.block import build_process_block

    print(json.dumps({"backend": jax.default_backend()}))
    spec = flagship_spec()
    fn = build_process_block(spec, jit=True, latency_mode=True, packed=True)
    x = np.random.RandomState(0).randn(2, spec.Nfft).astype(np.float32)
    np.asarray(fn(x))  # compile

    tiny = jax.jit(lambda a: (a * 2).sum())
    float(tiny(x))

    probe("np_input", lambda: np.asarray(fn(x)), args.iters)

    xd = jax.device_put(x)
    probe("reused_device_input", lambda: np.asarray(fn(xd)), args.iters)

    def deleted():
        d = jax.device_put(x)
        r = np.asarray(fn(d))
        d.delete()
        return r

    probe("deleted_device_input", deleted, args.iters)
    probe("tiny_jit", lambda: float(tiny(x)), args.iters)


if __name__ == "__main__":
    main()
