"""engine.program_syncs_per_batch: the host syncs the program's own code
makes a process_batch call, counted at their sites (``sync.*`` of
``npswf_tpu_torch.kernels.counts``) over its ``engine.process_batch``
calls. The counters cover the whole process: the warm-up, the window and
the traced slice call every pool batch 1, 1 and 2 times, so the ratio is
that of one pass over the pool. Nothing where the program keeps no such
counters."""


def read(ctx):
    from npswf_tpu_torch import kernels
    counts = dict(getattr(kernels, "counts", None) or {})
    calls = counts.get("engine.process_batch", 0)
    if not calls:
        return None
    return sum(v for k, v in counts.items() if k.startswith("sync.")) / calls
