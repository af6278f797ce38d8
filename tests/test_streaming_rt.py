"""Smoke the real-time streaming measurement harness end-to-end on the
CPU backend: spawned orchestrator + sim_frontend pacing CC11xx bursts +
packet accounting. An on-hardware bit-corruption bug was once found
by exactly this harness (clean-SNR bursts, zero decodes), so the
fabric it drives — packed single-fetch collect, pipelined dispatch,
varied payloads vs the MD5 dedup — stays covered here; device precision
hazards show only on an accelerator (chip_smoke.py covers that half on
the card)."""

import numpy as np


def test_streaming_rt_cpu_point():
    from pycusdr_tpu.bench.streaming_rt import run_point

    # max_batch=4 keeps the CPU child's batch-graph pre-compile small
    # (the shipped config's 16 matches dsp.block.BATCH_CHUNK)
    row = run_point(1.0, 12.0, basePort=29960, pipelineDepth=2,
                    drain_s=10.0, verbose=False, ready_timeout=90.0,
                    max_batch=4)
    # 4 bursts scheduled (t=1,4,7,10); allow one boundary/seam miss
    assert row["packets_scheduled"] == 4
    assert row["packets_bit_exact"] >= 3, row
    # every decoded payload matched its seeded expectation
    assert row["packets_decoded"] == row["packets_bit_exact"], row
