"""Multi-chip scaling: device meshes, sharded demodulation, halo
exchange, diversity-vote collectives.

The reference scales by running one OS process + one CUDA context per
Rx channel and shipping soft bits between hosts over ZMQ
(``pyCuSDR.py:244-251``, ``softCombiner.py:10``). Here the same three
degrees of parallelism are expressed as axes of a single
``jax.sharding.Mesh`` (SURVEY.md §2.5):

==========  =============================================================
mesh axis   what is sharded
==========  =============================================================
"channel"   Rx antenna channels (data parallelism; the vote is a device
            all-gather + weighted majority instead of ZMQ + CPU loops)
"dopp"      the Doppler-bin grid during carrier search and the
            matched-filter mask bank during demodulation (tensor
            parallelism over the search/filter dimension)
"time"      consecutive overlap-save signal blocks, with the
            ``sigOverlap``-sample halo exchanged between neighbour
            shards by ``jax.lax.ppermute`` (sequence parallelism)
==========  =============================================================
"""

from pycusdr_tpu.parallel.mesh import choose_mesh, make_mesh  # noqa: F401
from pycusdr_tpu.parallel.sharded_demod import build_sharded_demod_step  # noqa: F401
from pycusdr_tpu.parallel.halo import build_time_sharded_stream  # noqa: F401
from pycusdr_tpu.parallel.vote import vote_n_device  # noqa: F401
from pycusdr_tpu.parallel.channelizer import Channelizer, channelize_numpy  # noqa: F401
