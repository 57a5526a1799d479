"""runtime.merge_pct: the share of the traced run's window (one untraced
pass over the segment) that run_segment spent in its ordered merge of the
part files (its StageTimer ``merge`` stage, DEFLATE included)."""


def read(ctx):
    merge = (ctx.timers or {}).get("merge")
    if not merge or not ctx.window_s:
        return None
    return 100.0 * sum(merge) / ctx.window_s
