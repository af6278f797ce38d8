"""Time-sharded streaming demodulation with halo exchange.

The reference processes overlap-save blocks strictly serially on one
GPU: each block keeps the previous block's last ``2^overlap`` samples
as its head (``demodulator_process.py:287,337``). Here a long capture
is split into T hops sharded over the ``time`` mesh axis; the
``sigOverlap``-sample halo each block needs from its predecessor is
exchanged between neighbour shards with ``jax.lax.ppermute``,
then every shard demodulates its local blocks independently — the
mesh equivalent of the reference's sequence handling (SURVEY.md §2.5
"Sequence/block parallelism").
"""

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from pycusdr_tpu.dsp.block import build_process_block
from pycusdr_tpu.dsp.spec import DemodSpec


def build_time_sharded_stream(spec: DemodSpec, mesh: Mesh, axis: str = "time"):
    """Return ``stream(new_samples, carry_tail) -> dict`` jitted over ``mesh``.

    ``new_samples``: (T, 2, hop) float32 split complex (ops/cfft.py) —
    T consecutive hops of ``hop = Nfft - sigOverlap`` fresh samples,
    sharded over ``axis`` (T must divide by the axis size).
    ``carry_tail``: (2, sigOverlap) float32 — the tail carried in from
    the previous call (replicated).
    Outputs are the per-block result dict stacked on a leading T axis,
    plus ``carry_out`` for the next call. Requires hop >= sigOverlap so
    the halo spans at most one neighbour.
    """
    N = spec.Nfft
    ov = spec.sigOverlap
    hop = N - ov
    if hop < ov:
        raise ValueError(f"hop ({hop}) must be >= sigOverlap ({ov})")

    n_shards = mesh.shape[axis]
    core = build_process_block(spec, jit=False)

    def stream(new, carry_tail):
        # new: local (Tl, 2, hop); carry_tail: (2, ov) replicated
        my_tail = new[-1, :, hop - ov :]
        left_tail = jax.lax.ppermute(
            my_tail, axis, [(i, (i + 1) % n_shards) for i in range(n_shards)]
        )
        t_id = jax.lax.axis_index(axis)
        first_tail = jnp.where(t_id == 0, carry_tail, left_tail)
        intra = new[:-1, :, hop - ov :]  # (Tl-1, 2, ov) halos between local rows
        tails = jnp.concatenate([first_tail[None], intra], axis=0)
        blocks = jnp.concatenate([tails, new], axis=-1)  # (Tl, 2, Nfft)
        res = jax.vmap(core)(blocks)
        res.pop("E")  # (Tl, D, M) per-block energy: debug-only, keep the wire small
        return res

    # out specs: every output gains a leading local-T axis -> sharded on `axis`
    sample = jax.eval_shape(
        lambda b: jax.vmap(core)(b),
        jax.ShapeDtypeStruct((n_shards, 2, N), jnp.float32),
    )
    out_specs = {k: P(axis, *([None] * (v.ndim - 1))) for k, v in sample.items() if k != "E"}

    sharded = shard_map(
        stream,
        mesh=mesh,
        in_specs=(P(axis, None, None), P(None, None)),
        out_specs=out_specs,
        check_vma=False,
    )

    in_sharding = NamedSharding(mesh, P(axis, None, None))

    @jax.jit
    def run(new_samples, carry_tail):
        new_samples = jax.lax.with_sharding_constraint(new_samples, in_sharding)
        res = sharded(new_samples, carry_tail)
        carry_out = new_samples[-1, :, hop - ov :]
        return res, carry_out

    return run
