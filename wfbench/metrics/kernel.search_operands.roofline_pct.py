"""kernel.search_operands.roofline_pct: K2 (csrc/search.cu), the TSpectrum
search, as a share of its bound: roofline.search_bound of the present lanes
of the traced calls over the profiler's device time of every K2 launch in
them. Nothing when K2 did not run."""


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_outputs:
        return None
    launches = [k for k in t.kernels("npswf") if "search_kernel<" in k[0]]
    busy_s = sum(b - a for _, a, b, _ in launches) * 1e-6
    if busy_s <= 0:
        return None
    lanes = sum(int(ctx.pool_pres[i].sum()) for i, _ in ctx.traced_outputs)
    return 100.0 * ctx.roofline.search_bound(ctx.geometry, lanes,
                                             ctx.dtype)["seconds"] / busy_s
