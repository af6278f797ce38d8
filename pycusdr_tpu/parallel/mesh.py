"""Device-mesh construction helpers."""

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(axis_sizes: dict, devices=None) -> Mesh:
    """Build a Mesh with the given ``{axis_name: size}`` layout.

    The product of sizes must equal the number of devices used.
    """
    if devices is None:
        devices = jax.devices()
    shape = tuple(axis_sizes.values())
    n = int(np.prod(shape))
    if n > len(devices):
        raise ValueError(f"mesh {axis_sizes} needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, tuple(axis_sizes.keys()))


def choose_mesh(n_devices: int, devices=None) -> Mesh:
    """Default 2-D (channel, dopp) factorisation of ``n_devices``.

    Channels get the larger factor (they are the embarrassingly parallel
    axis); the doppler/mask axis takes a factor of 2 once there are at
    least four devices.
    """
    nd = 2 if (n_devices % 2 == 0 and n_devices >= 4) else 1
    nc = n_devices // nd
    return make_mesh({"channel": nc, "dopp": nd}, devices)
