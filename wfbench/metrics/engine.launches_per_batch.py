"""engine.launches_per_batch: device kernels (copies and sets left out) a
process_batch call in the traced slice, from the profiler's device
activities."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_calls or not t.device:
        return None
    return len(t.kernels()) / ctx.traced_calls
