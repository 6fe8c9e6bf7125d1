"""Distribution layer of the port: sharding rules, ring collectives,
pipeline, on ``torch.distributed`` (one process per rank).  Counterpart of
``repro.parallel``; ``mesh`` stands for its ``compat``."""

from . import collectives, mesh, sharding
from .sharding import (get_mesh, get_rules, logical, mesh_axes,
                       parallel_rules, resolve, set_mesh, set_rules, shard)
