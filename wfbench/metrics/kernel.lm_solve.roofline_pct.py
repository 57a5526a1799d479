"""kernel.lm_solve.roofline_pct: K3 (csrc/lm.cuh, lm_wide.cu), the whole LM
loop of a lane, as a share of its bound: roofline.lm_bound of the fitted
lanes of the traced calls (each lane at its own pulse count, the iterations
it spent over every stage and retry) over the profiler's device time of
every K3 launch in them. Nothing when K3 did not run."""

NAMES = ("lm_kernel<", "lm_wide_kernel<")


def read(ctx):
    t = ctx.trace
    if t is None or not ctx.traced_outputs:
        return None
    launches = [k for k in t.kernels("npswf")
                if any(n in k[0] for n in NAMES)]
    busy_s = sum(b - a for _, a, b, _ in launches) * 1e-6
    if busy_s <= 0:
        return None
    bound_s = 0.0
    for _, out in ctx.traced_outputs:
        fitted = out["fit_n_iter"] > 0
        bound_s += ctx.roofline.lm_bound(
            ctx.geometry, out["wfnpulse"][fitted], out["fit_n_iter"][fitted],
            ctx.dtype)["seconds"]
    return 100.0 * bound_s / busy_s
