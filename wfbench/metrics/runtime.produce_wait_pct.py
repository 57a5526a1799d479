"""runtime.produce_wait_pct: the share of the traced run's window (one
untraced pass over the segment) that run_segment's main thread spent
waiting for the next group its two stage workers produce (decode, upload,
process_batch): its StageTimer ``produce_wait``. Nothing where the program
records no such stage."""


def read(ctx):
    wait = (ctx.timers or {}).get("produce_wait")
    if not wait or not ctx.window_s:
        return None
    return 100.0 * sum(wait) / ctx.window_s
