"""Distribution substrate of the port: the mesh collectives the sort
engines use, over ``torch.distributed`` (``compat``), and the model stack's
logical-axis sharding table (``sharding``; on one device ``constrain`` is
the identity). The reference's remat policies, compression, ring and
pipeline parallelism, and the ``PartitionSpec`` rendering of the table,
wait for the parallel item of ROADMAP A13."""

from .compat import (all_gather, all_to_all, axis_index, axis_size,
                     make_mesh, ppermute)
from .sharding import DEFAULT_RULES, Rules, constrain

__all__ = ["axis_size", "axis_index", "ppermute", "all_gather", "all_to_all",
           "make_mesh", "Rules", "DEFAULT_RULES", "constrain"]
