"""fit.active_lanes_pct: the lanes the fit solved over the lanes it spanned,
from ``npswf_tpu_torch.kernels.counts`` (``fit.stage1_lanes`` /
``fit.launched_lanes``) over the whole process, whose passes call every
pool batch alike. A bucket that fits in place hands every lane of the batch
to ``fit_waveforms``, its gathers, its error model and K3, however few of
them it fits; a capped bucket hands its capacity. Nothing where the
program keeps no ``fit.launched_lanes`` counter."""


def read(ctx):
    from npswf_tpu_torch import kernels
    counts = dict(getattr(kernels, "counts", None) or {})
    if not counts.get("fit.launched_lanes"):
        return None
    return 100.0 * counts.get("fit.stage1_lanes", 0) / counts[
        "fit.launched_lanes"]
