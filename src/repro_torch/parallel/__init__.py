"""Distribution substrate of the port: the mesh collectives the sort
engines use, over ``torch.distributed`` (``compat``). The reference's
sharding rules, remat policies, compression and pipeline parallelism serve
its model stack, which the port has not ported (ROADMAP A13)."""

from .compat import (all_gather, all_to_all, axis_index, axis_size,
                     make_mesh, ppermute)

__all__ = ["axis_size", "axis_index", "ppermute", "all_gather", "all_to_all",
           "make_mesh"]
