"""Device inventory and the persistent compile cache.

Parity with the reference's GPU query (`lib/cudaConvertSMVer2Cores.py`,
used for kernel sizing): report what accelerators are attached and the
numbers that size our kernels (device memory, device kind).
"""

import logging
import os

log = logging.getLogger("pycusdr_tpu." + __name__)

#: compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is
#: unset: a fixed path inside the checkout (listed in .gitignore). The
#: path is part of the cache key, so it never moves between runs.
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".xla_cache")


def device_inventory():
    """List of dicts describing each visible accelerator."""
    import jax

    out = []
    for d in jax.devices():
        info = {
            "id": d.id,
            "platform": d.platform,
            "device_kind": getattr(d, "device_kind", "unknown"),
            "process_index": d.process_index,
        }
        try:
            stats = d.memory_stats() or {}
            info["hbm_bytes"] = stats.get("bytes_limit")
            info["hbm_in_use"] = stats.get("bytes_in_use")
        except Exception:
            pass
        out.append(info)
    return out


def log_inventory():
    for info in device_inventory():
        log.info("device %s: %s (%s), HBM %s", info["id"], info["device_kind"],
                 info["platform"], info.get("hbm_bytes"))


def configure_compile_cache(config_dir=None):
    """Turn on JAX's persistent compile cache; return its directory, or
    None when it stays off. Call before the first compilation.

    - ``JAX_COMPILATION_CACHE_DIR`` set: JAX already uses that
      directory; nothing here sets another, and ``config_dir`` is
      ignored.
    - otherwise ``config_dir`` (the config key
      ``TPU.compilationCacheDir``) names the directory; "" turns the
      cache off.
    - with neither, the cache goes to ``DEFAULT_CACHE_DIR`` on an
      accelerator backend and stays off on the CPU backend: XLA:CPU
      cache entries record compile-machine features that can mismatch
      the host that loads them, and CPU compiles take seconds anyway.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if config_dir == "":
        return None
    import jax

    if config_dir is None:
        if jax.default_backend() == "cpu":
            return None
        config_dir = DEFAULT_CACHE_DIR
    os.makedirs(config_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", config_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return config_dir
