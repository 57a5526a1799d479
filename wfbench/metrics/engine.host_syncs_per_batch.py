"""engine.host_syncs_per_batch: CUDA runtime calls that make the host wait
for the card (stream, device and event synchronizes) a process_batch call
in the traced slice, the synchronize that ends each call included (as
npswf_tpu_torch/trace.py counts them)."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_calls or not t.device:
        return None
    return t.syncs() / ctx.traced_calls
