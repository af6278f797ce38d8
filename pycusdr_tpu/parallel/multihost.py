"""Multi-host pod-slice support.

The reference distributes across hosts with ZMQ over TCP (remote
decoder via ``demodOutExternal``, dispersed ground stations feeding one
softCombiner — SURVEY §2.5). Here the story is one distributed JAX
program: ``jax.distributed`` + a global mesh where the ``channel`` axis
spans hosts (each ground station contributes its local devices'
channels), the intra-host interconnect carries the intra-host
collectives and the network the cross-host ones. ZMQ
stays only at the RF edge (each host's GNU Radio feeds its local
channels); the vote that softCombiner did over TCP becomes the
``all_gather`` in ``parallel.sharded_demod``.

Single-chip/CI environments: everything degrades to the local mesh.
"""

import logging

import numpy as np

log = logging.getLogger("pycusdr_tpu." + __name__)


def init_distributed(coordinator_address=None, num_processes=None, process_id=None):
    """Initialize jax.distributed from explicit args or the standard
    env vars (JAX_COORDINATOR_ADDRESS etc.). No-op when single-process."""
    import jax

    if num_processes is None:
        # defer to the standard env vars (JAX_COORDINATOR_ADDRESS,
        # JAX_NUM_PROCESSES, JAX_PROCESS_ID / cluster autodetection)
        import os

        if not (os.environ.get("JAX_COORDINATOR_ADDRESS")
                or os.environ.get("COORDINATOR_ADDRESS")):
            log.info("single-process run: jax.distributed not initialized")
            return False
        jax.distributed.initialize()
        log.info("jax.distributed up from env: process %d/%d",
                 jax.process_index(), jax.process_count())
        return True
    if num_processes <= 1:
        log.info("single-process run: jax.distributed not initialized")
        return False
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    log.info("jax.distributed up: process %d/%d, %d local / %d global devices",
             jax.process_index(), jax.process_count(),
             jax.local_device_count(), jax.device_count())
    return True


def make_global_mesh(dopp: int = 1):
    """A (channel, dopp) mesh over ALL processes' devices.

    The channel axis is laid out host-major so each host's Rx channels
    map to its local chips — halo and vote collectives between channels
    of one station stay on its host, only the cross-station vote crosses
    the network.
    """
    import jax
    from jax.sharding import Mesh

    devs = np.asarray(jax.devices())
    n = len(devs)
    if n % dopp:
        raise ValueError(f"{n} devices do not factor into dopp={dopp}")
    return Mesh(devs.reshape(n // dopp, dopp), ("channel", "dopp"))


def local_channel_slice(mesh, n_channels_global: int):
    """Which global channel rows this process should feed with samples
    (host-local IQ ingest writes only its own shard)."""
    import jax

    if n_channels_global % jax.process_count():
        raise ValueError(
            f"{n_channels_global} channels do not divide over "
            f"{jax.process_count()} processes"
        )
    per = n_channels_global // jax.process_count()
    lo = jax.process_index() * per
    return slice(lo, lo + per)
