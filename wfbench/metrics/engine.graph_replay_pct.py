"""engine.graph_replay_pct: the share of process_batch calls served by CUDA
graph replays (``engine.graph_replays`` over ``engine.process_batch`` of
``npswf_tpu_torch.kernels.counts``) over the whole process: the warm-up,
the window and the traced slice. An instance's first call runs the eager
body before its graphs are captured, so a process of one instance reads
one call short of 100. Nothing where the program keeps no
``engine.graph_replays`` counter."""


def read(ctx):
    from npswf_tpu_torch import kernels
    counts = dict(getattr(kernels, "counts", None) or {})
    calls = counts.get("engine.process_batch", 0)
    if not calls or "engine.graph_replays" not in counts:
        return None
    return 100.0 * counts["engine.graph_replays"] / calls
