"""Data parallelism of the port: meshes (``mesh.py``) and the placement
of batches and weights on them, with an engine's height split
(``sharding.py``)."""

from .mesh import (Mesh, batch_sharding, free_port,  # noqa: F401
                   make_mesh, maybe_init_distributed, pad_batch_to_devices,
                   replicated)
from .sharding import (choose_spec, halo_rows, put_frames,  # noqa: F401
                       put_replicated, row_parts, shard_items)
