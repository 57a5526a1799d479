"""fit.retry_lanes_pct: the lanes the fit's retry ladder solved again (each
rung: stage 2 and each stage-3 pull-back) over the lanes stage 1 solved,
from ``npswf_tpu_torch.kernels.counts`` (``fit.retry_lanes`` /
``fit.stage1_lanes``) over the whole process, whose passes call every
pool batch alike. Operations retried, as a share of those attempted.
Nothing where the program keeps no such counters."""


def read(ctx):
    from npswf_tpu_torch import kernels
    counts = dict(getattr(kernels, "counts", None) or {})
    if not counts.get("fit.stage1_lanes"):
        return None
    return 100.0 * counts.get("fit.retry_lanes", 0) / counts["fit.stage1_lanes"]
