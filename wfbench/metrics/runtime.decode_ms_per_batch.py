"""runtime.decode_ms_per_batch: run_segment's decode stage (raw stream to
dense batch, the HMS correction) in host milliseconds a batch, over the
traced run's window of one untraced pass (StageTimer ``decode``; both
stage workers' calls)."""


def read(ctx):
    decode = (ctx.timers or {}).get("decode")
    if not decode:
        return None
    return 1e3 * sum(decode) / len(decode)
