"""device.idle_pct.segment: the share of one traced run_segment pass (its
host span) in which no kernel, copy or set ran on any stream of the card."""


def read(ctx):
    t = ctx.trace
    if t is None or t.span_us <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us / t.span_us)
