"""Distributed layer — counterpart of ``mcax/dist/``, on ``torch.distributed``.

One process per card on a 2-axis ``('time', 'channel')`` mesh of the
default process group (``mesh.py``):

  * ``time``    — sequence parallelism over frame blocks, with the
                  overlap-save halo exchange between neighbours (halo.py),
  * ``channel`` — tensor parallelism over microphones / mic pairs / bins,
                  reduced with all_reduce / all_gather (sharded.py),

and the exact covariance recursion combined across time shards (scan.py).
``multihost.py`` joins the process group (gloo on the CPU, NCCL on cards).
"""

from mcax_torch.dist import mesh as mesh
from mcax_torch.dist import halo as halo
from mcax_torch.dist import scan as scan
from mcax_torch.dist.sharded import ShardedPipeline as ShardedPipeline
