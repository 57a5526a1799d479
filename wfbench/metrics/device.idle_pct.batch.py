"""device.idle_pct.batch: the share of the traced slice (the traffic file's
``trace_calls`` process_batch calls back to back on the pool, right after
the traced run's window of one call a pool batch, each ending in a
synchronize) in which no kernel, copy or set
ran on any stream of the card."""


def read(ctx):
    t = ctx.trace
    if t is None or t.span_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us / t.span_us)
