"""Batched bounded Levenberg-Marquardt fit with the retry ladder.

Counterpart of npswf_tpu/fit/lm.py (Minuit2/Migrad per block in the
reference, TEST_2.C:691-791). Every fit lane is solved at once:

- chi^2 over bins [fit_lo_bin, fit_hi_bin) with the reference's error model;
- box constraints through the Minuit sin transform p = mid + half*sin(u);
- normal-equation LM steps with Jacobi scaling and Marquardt damping;
- the ladder: stage 1 from the seeds; stage 2 restarts the failed lanes
  from the seeds with lambda0 * 10 and the stage-2 budgets; stage 3 pulls
  bound-saturated components of the stage-1 end state back to sin(u) = +-m
  for each rung m in ``lm_stage3_pullbacks``; still-failed lanes report
  their seeds. Where K3 serves the bucket on the card at a compiled width
  the whole ladder is one K3 launch (``lm_kernel.lm_ladder_kernel``);
  elsewhere the host runs the rungs (``host_ladder``), each over the lanes
  it retries.

``lm_solve`` routes as the reference package does: a spline solve within
``pallas_lm_max_pulses`` runs whole on the K3 kernel (fit/lm_kernel.py)
when ``use_pallas_lm`` is set and neither fused flag is; every other solve
runs the generic iteration ``lm_loop``, whose system evaluation is K6
(``use_fused_system``), K5 then K7 (``use_fused_neq``, P <= NARROW_P), or
the model's evaluation (K5 for the planes model) then the normal equations
as a batched product. ``plain=True`` runs the plain version of every
kernel instead.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.fit.eval_kernel import (NARROW_P, dp_du, fused_eval,
                                             fused_eval_plain, fused_neq,
                                             fused_neq_plain, fused_system,
                                             fused_system_plain, to_physical)
from npswf_tpu_torch.fit.linalg import cholesky_solve
from npswf_tpu_torch.models.waveform import WaveformModel, get_model
from npswf_tpu_torch.utils.timers import span


class FitInputs(NamedTuple):
    y: torch.Tensor            # [N, K] data in the fit window
    sigma: torch.Tensor        # [N, K] errors (err model applied upstream)
    coeffs: torch.Tensor       # [N, S, 4] per-lane spline coefficients
    x0: torch.Tensor           # [N] spline first knot
    t_seed: torch.Tensor       # [N, P] seed times (relative to timeref)
    a_seed: torch.Tensor       # [N, P] seed amplitudes
    ped_seed: torch.Tensor     # [N] pedestal seed (mean of first 20 samples)
    pulse_mask: torch.Tensor   # [N, P] bool — pulse slot active
    active: torch.Tensor       # [N] bool — lane has >=1 pulse and passed gates
    timeref: Optional[torch.Tensor] = None   # [N] block reference time


class FitResult(NamedTuple):
    params: torch.Tensor       # [N, M] fitted physical parameters
    chi2: torch.Tensor         # [N] total chi^2 (not yet / ndf)
    chi2_ndf: torch.Tensor     # [N] chi^2 / ndf
    converged: torch.Tensor    # [N] bool — fit succeeded (possibly on retry)
    converged_stage1: torch.Tensor  # [N] bool — succeeded without retry
    n_iter: torch.Tensor       # [N] iterations consumed
    edm: torch.Tensor          # [N] final expected-distance-to-minimum proxy
    # [R] int32 on the card where K3 ran the ladder whole: the lanes each
    # rung after stage 1 solved again (0 for a rung that did not run), for
    # process_batch to fold into kernels.counts with count_rung_lanes; None
    # where the host ladder counted its rungs itself
    rung_lanes: Optional[torch.Tensor] = None


# |sin(u)| above this counts as "on its bound" for the KKT convergence mask
SAT_THRESH = 0.9995
CHOL_EPS = 1e-30


def _interleave(first, t, a):
    """[N], [N,P], [N,P] -> [N, 1+2P] in the (ped, t0, A0, ...) layout."""
    inter = torch.stack([t, a], dim=-1).reshape(t.shape[0], -1)
    return torch.cat([first[:, None], inter], dim=1)


def _bounds(cfg: NPSConfig, inp: FitInputs):
    """(lo, hi) [N, M] (ref TEST_2.C:664-670)."""
    N = inp.t_seed.shape[0]
    a_lo = inp.a_seed * cfg.amp_lo_frac
    a_hi = inp.a_seed * cfg.amp_hi_frac
    ped = torch.full((N,), cfg.ped_limit, dtype=inp.y.dtype,
                     device=inp.y.device)
    lo = _interleave(-ped, inp.t_seed - cfg.time_limit,
                     torch.minimum(a_lo, a_hi))
    hi = _interleave(ped, inp.t_seed + cfg.time_limit,
                     torch.maximum(a_lo, a_hi))
    return lo, hi


def _seed_params(cfg: NPSConfig, inp: FitInputs):
    return _interleave(torch.clamp(inp.ped_seed, -cfg.ped_limit, cfg.ped_limit),
                       inp.t_seed, inp.a_seed)


def _to_internal(p, lo, hi, param_mask):
    mid = 0.5 * (lo + hi)
    half = 0.5 * (hi - lo)
    safe_half = torch.where(half > 0, half, 1.0)
    u = torch.asin(torch.clamp((p - mid) / safe_half, -1.0, 1.0))
    return torch.where(param_mask & (half > 0), u, 0.0)


def model_system(cfg: NPSConfig, model: WaveformModel, aux, y, w, pulse_mask,
                 lo, hi, p_seed, param_mask, variant: str = "model",
                 plain: bool = False):
    """u -> (A [N,M,M], g [N,M], chi2 [N]) for ``model`` on data y, w=1/sigma.

    ``variant``: "model" evaluates ``model.eval_and_jac`` and forms the
    normal equations as batched products (the reference package leaves
    them to XLA); "fused_neq" runs K5 then K7 and "fused_system" K6, both
    on the padded segment planes. ``plain`` runs the kernels' plain
    versions."""
    if variant == "fused_system":
        run = fused_system_plain if plain else fused_system

        def system(u):
            return run(cfg, aux["coeffs_pad"], aux["x0"], y, w, u, lo, hi,
                       p_seed, param_mask)
    elif variant == "fused_neq":
        ev = fused_eval_plain if plain else fused_eval
        neq = fused_neq_plain if plain else fused_neq

        def system(u):
            p = to_physical(u, lo, hi, p_seed, param_mask)
            f, jt, ja = ev(cfg, aux["coeffs_pad"], aux["x0"], p[:, 1::2],
                           p[:, 2::2], p[:, 0], pulse_mask)
            return neq(cfg, y, w, f, jt, ja, dp_du(u, lo, hi, param_mask))
    elif variant == "model":
        xgrid = torch.arange(cfg.fit_lo_bin, cfg.fit_hi_bin, dtype=y.dtype,
                             device=y.device)

        def system(u):
            p = to_physical(u, lo, hi, p_seed, param_mask)
            f, Jp = model.eval_and_jac(cfg, p, aux, xgrid, pulse_mask,
                                       plain=plain)
            r = (y - f) * w
            Ju = Jp * dp_du(u, lo, hi, param_mask)[:, None, :] * w[:, :, None]
            A = torch.bmm(Ju.transpose(1, 2), Ju)
            g = torch.bmm(Ju.transpose(1, 2), r[:, :, None])[:, :, 0]
            return A, g, torch.sum(r * r, dim=1)
    else:
        raise ValueError(f"unknown system variant {variant!r}")
    return system


def lm_loop(cfg: NPSConfig, system, u0, lo, hi, param_mask, active,
            max_iter: int, lam0, iter_budget=None):
    """The generic LM iteration from internal params u0 on ``active`` lanes
    (npswf_tpu/fit/lm.py:121-310), K3's loop in plain PyTorch.

    ``iter_budget`` [N] gives each lane its own (<= max_iter) budget; a lane
    that spends it freezes unconverged. ``lam0`` is a scalar or [N].
    Returns (u, chi2, converged, n_iter, edm, lam)."""
    dtype, dev = u0.dtype, u0.device
    N, M = u0.shape
    eye = torch.eye(M, dtype=dtype, device=dev)
    # a device tensor, not a Python float: PyTorch's CUDA division by a CPU
    # scalar multiplies by its reciprocal, which rounds unlike the kernel's
    lam_down = torch.tensor(cfg.lm_lambda_down, dtype=dtype, device=dev)
    eps = float(torch.finfo(dtype).eps)
    ftol_eff = max(cfg.lm_ftol, 100.0 * eps)
    gtol_eff = max(cfg.lm_gtol, 100.0 * eps)

    def solve_damped(A, g, lam):
        diag = torch.diagonal(A, dim1=1, dim2=2)
        scale = torch.where(diag > 1e-30, torch.sqrt(diag), 1.0)   # Jacobi
        As = A / (scale[:, :, None] * scale[:, None, :])
        dead = diag <= 1e-30                  # fixed/masked params
        As = torch.where(dead[:, :, None] | dead[:, None, :], 0.0, As)
        damped = As * (1.0 - eye[None]) + eye[None] * (1.0 + lam[:, None, None])
        gs = torch.where(dead, 0.0, g / scale)
        delta = cholesky_solve(damped, gs, CHOL_EPS) / scale
        return torch.where(dead, 0.0, delta)

    def gcrit_of(A, g, chi2, u):
        # MINPACK scaled gradient over the KKT-free components: a component
        # pinned at its bound whose descent points outward is skipped
        diag = torch.diagonal(A, dim1=1, dim2=2)
        dead = diag <= 1e-30
        sinu = torch.sin(u)
        push = g * dp_du(u, lo, hi, param_mask)
        kkt = (((sinu > SAT_THRESH) & (push > 0))
               | ((sinu < -SAT_THRESH) & (push < 0)))
        denom = (torch.sqrt(torch.where(dead, 1.0, diag))
                 * torch.sqrt(torch.clamp(chi2, min=eps))[:, None])
        return torch.amax(torch.where(dead | kkt, 0.0, torch.abs(g)) / denom,
                          dim=1)

    if iter_budget is None:
        iter_budget = torch.full((N,), max_iter, dtype=torch.int32, device=dev)
    # the normal equations of the current point are cached, so each step
    # costs one system evaluation (at the trial point)
    A, g, chi2_0 = system(u0)
    u = u0
    chi2 = torch.where(active, chi2_0, 0.0)
    lam = torch.zeros((N,), dtype=dtype, device=dev) + lam0
    done = ~active | (iter_budget <= 0)
    conv = torch.zeros((N,), dtype=torch.bool, device=dev)
    n_iter = torch.zeros((N,), dtype=torch.int32, device=dev)
    edm = torch.full((N,), float("inf"), dtype=dtype, device=dev)
    for _ in range(max_iter):
        kernels.count("sync.fit.lm_loop_done")
        if bool(done.all()):
            break
        gcrit = gcrit_of(A, g, chi2, u)
        conv_g = gcrit < gtol_eff
        u_try = u + solve_damped(A, g, lam)
        A_t, g_t, chi2_try = system(u_try)
        good = torch.isfinite(chi2_try) & (chi2_try < chi2)
        step = good & ~done & ~conv_g
        u = torch.where(step[:, None], u_try, u)
        A = torch.where(step[:, None, None], A_t, A)
        g = torch.where(step[:, None], g_t, g)
        chi2_new = torch.where(step, chi2_try, chi2)
        lam_new = torch.clamp(torch.where(step, lam / lam_down,
                                          lam * cfg.lm_lambda_up),
                              cfg.lm_lambda_min, cfg.lm_lambda_max)
        rel_impr = (chi2 - chi2_new) / torch.clamp(chi2, min=1.0)
        conv_f = step & (rel_impr < ftol_eff)
        conv_now = ~done & (conv_g | conv_f)
        n_iter = torch.where(done, n_iter, n_iter + 1)
        lam = torch.where(done, lam, lam_new)
        edm = torch.where(done, edm, gcrit)
        chi2 = chi2_new
        conv = conv | conv_now
        done = done | conv_now | (n_iter >= iter_budget)
    return u, chi2, conv & active, n_iter, edm, lam


def _kernel_lm_active(cfg: NPSConfig, model: WaveformModel, P: int) -> bool:
    """Whether the whole-loop K3 kernel serves this solve (the reference
    package's _pallas_lm_active): spline planes model, P within
    ``pallas_lm_max_pulses``, ``use_pallas_lm`` set and no fused flag."""
    return (cfg.use_pallas_lm and P <= cfg.pallas_lm_max_pulses
            and model.name == "spline_ref_pallas"
            and not cfg.use_fused_system and not cfg.use_fused_neq)


def _system_variant(cfg: NPSConfig, model: WaveformModel, P: int) -> str:
    """The generic loop's system evaluation (npswf_tpu/fit/lm.py:161-200)."""
    if model.name != "spline_ref_pallas":
        return "model"
    if cfg.use_fused_system:
        return "fused_system"
    if cfg.use_fused_neq and P <= NARROW_P:
        return "fused_neq"
    return "model"


def _ladder_fused(cfg: NPSConfig, model: WaveformModel, P: int,
                  device: torch.device) -> bool:
    """Whether a bucket's whole ladder runs as one K3 launch: its lanes are
    on the card and K3 serves them at a compiled width (P <=
    LM_COMPILED_PULSES, csrc/lm.cuh kMaxP). Elsewhere K3's wrapper runs its
    plain version, and the host ladder over ``lm_solve`` is the launch's."""
    from npswf_tpu_torch.fit.lm_kernel import LM_COMPILED_PULSES
    return (device.type == "cuda" and _kernel_lm_active(cfg, model, P)
            and P <= LM_COMPILED_PULSES)


def ladder_rungs(cfg: NPSConfig) -> int:
    """The rungs after stage 1: the stage-2 restart and each pull-back."""
    return 1 + (len(cfg.lm_stage3_pullbacks) if cfg.lm_stage3 else 0)


def count_rung_lanes(values) -> None:
    """Fold rung tallies on the host (``host_ladder``'s, or
    ``FitResult.rung_lanes`` of any number of fits read back, as ints) into
    ``kernels.counts``: a rung that retried lanes is one of ``fit.rungs``,
    and its lanes count in ``fit.retry_lanes``."""
    values = [int(v) for v in values]
    kernels.count("fit.rungs", sum(1 for v in values if v))
    kernels.count("fit.retry_lanes", sum(values))


def _aux(cfg: NPSConfig, model: WaveformModel, inp: FitInputs):
    base_aux = {"coeffs": inp.coeffs, "x0": inp.x0,
                "timeref": (inp.timeref if inp.timeref is not None
                            else torch.zeros_like(inp.x0))}
    for k, v in cfg.model_aux:
        base_aux[k] = torch.full_like(inp.x0, v)
    return model.prepare_aux(cfg, base_aux)


def lm_solve(cfg: NPSConfig, model: WaveformModel, inp: FitInputs, u0, lo, hi,
             p_seed, param_mask, active, max_iter: int, lam0,
             iter_budget=None, plain: bool = False):
    """Run LM from internal params u0 on ``active`` lanes.
    Returns (u, chi2, converged, n_iter, edm, lam)."""
    w = 1.0 / inp.sigma
    aux = _aux(cfg, model, inp)
    P = inp.t_seed.shape[1]
    if _kernel_lm_active(cfg, model, P):
        from npswf_tpu_torch.fit.lm_kernel import lm_solve_kernel, lm_solve_plain
        run = lm_solve_plain if plain else lm_solve_kernel
        return run(cfg, aux["coeffs_pad"], inp.x0, inp.y, w, u0, lo, hi,
                   p_seed, param_mask, active, max_iter, lam0, iter_budget)
    system = model_system(cfg, model, aux, inp.y, w, inp.pulse_mask, lo, hi,
                          p_seed, param_mask,
                          variant=_system_variant(cfg, model, P), plain=plain)
    return lm_loop(cfg, system, u0, lo, hi, param_mask, active, max_iter,
                   lam0, iter_budget)


def _prepare(cfg: NPSConfig, inp: FitInputs):
    """Bounds, seeds, param mask, internal start point, per-lane budgets."""
    lo, hi = _bounds(cfg, inp)
    p_seed = _seed_params(cfg, inp)
    pm = torch.cat([torch.ones_like(inp.pulse_mask[:, :1]),
                    torch.repeat_interleave(inp.pulse_mask, 2, dim=1)], dim=1)
    u0 = _to_internal(p_seed, lo, hi, pm)
    # budgets keyed on the lane's own pulse count, so routing stays
    # result-neutral
    wide = inp.pulse_mask.sum(dim=1) > cfg.lm_wide_pulses
    s1_budget = torch.where(wide, cfg.lm_stage1_wide,
                            cfg.lm_max_iter_stage1).to(torch.int32)
    s2_budget = torch.where(wide, cfg.lm_stage2_wide,
                            cfg.lm_max_iter_stage2).to(torch.int32)
    return lo, hi, p_seed, pm, u0, s1_budget, s2_budget


def host_ladder(cfg: NPSConfig, solve, lanes, u0, pm, active, s1_cap: int,
                s1_budget, s2_cap: int, s2_budget):
    """Stage 1, then each rung of the ladder on the host over the lanes it
    retries.

    ``solve(lanes, u_start, active, max_iter, lam0, budget)`` runs one LM
    stage and returns ``lm_solve``'s tuple; ``lanes`` is a tuple of the
    per-lane tensors (or None) it reads besides, gathered for each rung.
    Stage 1 is the span ``fit.stage1`` and each rung (stage 2, each
    pull-back) a ``fit.retry``; each rung's test and select are host syncs,
    counted by site. Returns (u1, chi2_1, conv1, it1, edm1, u2, chi2_2,
    conv2, it2, rung_lanes), rung_lanes a list of ``ladder_rungs(cfg)``
    ints: the lanes each rung retried, 0 where it did not run."""
    # stage 1 runs as one piece (no tier, no chunking: both are layouts of
    # the same row-wise iteration)
    with span("fit.stage1"):
        u1, chi2_1, conv1, it1, edm1, _ = solve(
            lanes, u0, active, s1_cap, cfg.lm_lambda_init, s1_budget)
    rung_lanes = [0] * ladder_rungs(cfg)

    def retry(rung, mask, start_u, lam0):
        """Re-solve the ``mask`` lanes from ``start_u`` with the stage-2
        budgets. The reference package walks them in chunks of N/32 and N/64;
        chunking is layout only (the LM update is row-wise), so every masked
        lane is gathered into one call here. Rows outside ``mask`` are zero."""
        with span("fit.retry"):
            sel = torch.nonzero(mask).squeeze(1)
            kernels.count("sync.fit.retry_select")
            rung_lanes[rung] = sel.numel()

            def take(a):
                return None if a is None else a.index_select(0, sel)
            u_c, chi2_c, conv_c, it_c, _, _ = solve(
                tuple(take(v) for v in lanes), take(start_u), take(mask),
                s2_cap, lam0, take(s2_budget))
            u2 = torch.zeros_like(u1).index_copy(0, sel, u_c)
            chi2_2 = torch.zeros_like(chi2_1).index_copy(0, sel, chi2_c)
            conv2 = torch.zeros_like(conv1).index_copy(0, sel, conv_c)
            it2 = torch.zeros_like(it1).index_copy(0, sel, it_c)
            return u2, chi2_2, conv2, it2

    failed1 = active & ~conv1
    # each retry runs only when some lane needs it (a host sync)
    kernels.count("sync.fit.ladder_any")
    if bool(failed1.any()):
        u2, chi2_2, conv2, it2 = retry(0, failed1, u0,
                                       cfg.lm_lambda_init * 10.0)
    else:
        u2, chi2_2 = torch.zeros_like(u1), torch.zeros_like(chi2_1)
        conv2, it2 = torch.zeros_like(conv1), torch.zeros_like(it1)

    if cfg.lm_stage3:
        for rung, pullback in enumerate(cfg.lm_stage3_pullbacks, 1):
            failed2 = failed1 & ~conv2
            kernels.count("sync.fit.ladder_any")
            if not bool(failed2.any()):
                break
            sinu1 = torch.sin(u1)
            sat = torch.abs(sinu1) > 0.95
            u_pb = torch.where(sat & pm,
                               torch.asin(float(pullback) * torch.sign(sinu1)),
                               u1)
            u3, chi2_3, conv3, it3 = retry(rung, failed2, u_pb,
                                           cfg.lm_lambda_init)
            use3 = failed2 & conv3
            u2 = torch.where(use3[:, None], u3, u2)
            chi2_2 = torch.where(use3, chi2_3, chi2_2)
            conv2 = conv2 | use3
            it2 = it2 + torch.where(failed2, it3, 0)
    return u1, chi2_1, conv1, it1, edm1, u2, chi2_2, conv2, it2, rung_lanes


def fit_waveforms(cfg: NPSConfig, inp: FitInputs, model_name: str = "",
                  plain: bool = False) -> FitResult:
    """The escalated batched fit: stage 1, the stage-2 seed restart and the
    stage-3 pull-back rungs, merged into one FitResult.

    Where K3 serves the bucket on the card at a compiled width
    (``_ladder_fused``) and ``plain`` is off, the whole ladder is one K3
    launch under the span ``fit.ladder`` (``kernels.counts``:
    ``fit.ladder_fused``), and the result's ``rung_lanes`` holds the lanes
    each rung retried, on the device, for the caller to fold with
    ``count_rung_lanes`` where it next reads the device back
    (``process_batch`` does, once a call). Elsewhere ``host_ladder`` runs
    it (``fit.ladder_host``), and its rungs are counted at once."""
    model = get_model(model_name or cfg.model_name)
    lo, hi, p_seed, pm, u0, s1_budget, s2_budget = _prepare(cfg, inp)
    s1_cap = max(cfg.lm_max_iter_stage1, cfg.lm_stage1_wide)
    s2_cap = max(cfg.lm_max_iter_stage2, cfg.lm_stage2_wide)
    P = inp.t_seed.shape[1]
    if not plain and _ladder_fused(cfg, model, P, inp.y.device):
        from npswf_tpu_torch.fit.lm_kernel import lm_ladder_kernel
        kernels.count("fit.ladder_fused")
        with span("fit.ladder"):
            aux = _aux(cfg, model, inp)
            *stages, rung_lanes = lm_ladder_kernel(
                cfg, aux["coeffs_pad"], inp.x0, inp.y, 1.0 / inp.sigma, u0,
                lo, hi, p_seed, pm, inp.active, s1_cap, s1_budget, s2_cap,
                s2_budget)
    else:
        kernels.count("fit.ladder_host")

        def solve(lanes, u, active, max_iter, lam0, budget):
            return lm_solve(cfg, model, FitInputs(*lanes[:-4]), u,
                            *lanes[-4:], active, max_iter, lam0, budget,
                            plain=plain)
        *stages, rungs = host_ladder(
            cfg, solve, tuple(inp) + (lo, hi, p_seed, pm), u0, pm,
            inp.active, s1_cap, s1_budget, s2_cap, s2_budget)
        count_rung_lanes(rungs)
        rung_lanes = None
    u1, chi2_1, conv1, it1, edm1, u2, chi2_2, conv2, it2 = stages
    failed1 = inp.active & ~conv1
    return _combine(cfg, inp, u1, chi2_1, conv1, it1, edm1, failed1, u2,
                    chi2_2, conv2, it2, lo, hi, p_seed, pm)._replace(
                        rung_lanes=rung_lanes)


def _combine(cfg, inp, u1, chi2_1, conv1, it1, edm1, failed1, u2, chi2_2,
             conv2, it2, lo, hi, p_seed, pm) -> FitResult:
    """Merge the stage results into the public FitResult."""
    use2 = failed1 & conv2
    u = torch.where(use2[:, None], u2, u1)
    chi2 = torch.where(use2, chi2_2, chi2_1)
    converged = conv1 | use2
    params = to_physical(u, lo, hi, p_seed, pm)
    # still-failed lanes report their seeds (ref :774-791 fallback)
    params = torch.where((inp.active & ~converged)[:, None], p_seed, params)
    nfree = 1 + 2 * inp.pulse_mask.sum(dim=1)
    ndf = torch.clamp(inp.y.shape[1] - nfree, min=1).to(inp.y.dtype)
    return FitResult(params=params, chi2=chi2, chi2_ndf=chi2 / ndf,
                     converged=converged, converged_stage1=conv1,
                     n_iter=it1 + it2, edm=edm1)
