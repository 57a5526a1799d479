"""runtime.write_wait_pct: the share of the traced run's window (one
untraced pass over the segment) that run_segment's main thread spent
waiting for its writer thread's backlog of part files, the final drain
included: its StageTimer ``write_wait``. Nothing where the program records
no such stage."""


def read(ctx):
    wait = (ctx.timers or {}).get("write_wait")
    if not wait or not ctx.window_s:
        return None
    return 100.0 * sum(wait) / ctx.window_s
