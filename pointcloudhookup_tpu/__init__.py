"""pointcloudhookup_tpu — JAX power-line inspection framework for NVIDIA GPUs.

A ground-up JAX/XLA re-design of the capabilities of
Daniel-Starr/pointcloudhookup (a PyQt/VTK desktop tool): LAS corridor
ingest, voxel-grid downsampling, ground removal, DBSCAN-style tower
extraction with oriented-bounding-box fitting, CGCS2000<->WGS84 CRS +
geoid elevation conversion, GIM (776-byte header + 7z of CBM/FAM files)
parsing/matching/correction/write-back — all headless, batched, and
compiled for the GPU by XLA.

Layering (bottom-up):
  core/      padded array schemas, device mesh helpers, streaming
  io/        host-side codecs: LAS, 7z, GIM container, CBM/FAM
  ops/       device compute primitives (voxel, percentile, cluster, obb, geo, ...)
  models/    tower schemas + the flagship extraction model
  parallel/  multi-device (mesh/pjit/shard_map) versions of the pipeline
  viz/       display-geometry exports (bounding boxes, linesets)
  utils/     logging/progress plumbing, timers, validation
"""

__version__ = "0.1.0"

from pointcloudhookup_tpu.config import (  # noqa: F401
    ExtractParams,
    MatchParams,
    VoxelParams,
)
