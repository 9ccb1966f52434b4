"""Distribution substrate of the port: the mesh collectives over
``torch.distributed`` and the active mesh (``compat``), the logical-axis
sharding plan rendered as DTensor placements (``sharding``), the ring
collectives (``ring``), GPipe pipelining (``pipeline``) and int8 gradient
compression with error feedback (``compression``)."""

from .compat import (all_gather, all_to_all, axis_index, axis_size, get_mesh,
                     make_mesh, pmax, ppermute, psum, set_mesh)
from .sharding import (DEFAULT_RULES, NamedSharding, Rules, constrain,
                       placements, spec_for)

__all__ = ["axis_size", "axis_index", "ppermute", "all_gather", "all_to_all",
           "psum", "pmax", "make_mesh", "set_mesh", "get_mesh", "Rules",
           "DEFAULT_RULES", "NamedSharding", "constrain", "placements",
           "spec_for"]
