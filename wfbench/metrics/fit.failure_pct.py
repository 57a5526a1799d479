"""fit.failure_pct: fits that failed after the whole retry ladder over
fitted lanes (n_fit_failure / (n_fit_success + n_fit_failure)), summed over
the traced run's window: one process_batch call a pool batch, the same
answers every call of the pool gives. A physics result the
reference reproduces, not a failed operation."""


def read(ctx):
    fit = ctx.fit
    if not fit or fit["success"] + fit["failure"] == 0:
        return None
    return 100.0 * fit["failure"] / (fit["success"] + fit["failure"])
