"""The multi-device path: a (data, block) mesh of ranks on torch.distributed
(``mesh``), the per-rank axes its collectives run on (``axis``) and a
self-checking dry run (``dryrun``).

The names of ``mesh`` are loaded on first use: ``engine.pipeline`` imports
``parallel.axis``, and ``mesh`` imports ``engine.pipeline``.
"""
import importlib

__all__ = ["Mesh", "RankMesh", "gather_output", "launch", "make_mesh",
           "make_sharded_pipeline", "shard_calibration", "shard_event_batch",
           "sharded_cluster_sums", "sharded_process_batch", "world_of_one"]


def __getattr__(name):
    if name in __all__:
        return getattr(importlib.import_module(__name__ + ".mesh"), name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
