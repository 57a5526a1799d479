"""The fit's retry ladder as one K3 launch, on the CPU.

On the card a bucket that K3 serves at a compiled width runs stage 1, the
stage-2 restart and the pull-back rungs in one launch
(``fit.lm_kernel.lm_ladder_kernel``, csrc/lm.cuh): every lane climbs the
rungs on its own, with no gather and no host test between them. That is
result-neutral only because the LM iteration is row-wise: a rung solved
over every lane with the rung's lanes as ``active`` equals the host's rung
over the gathered lanes, bit for bit. The first tests hold that property
(an in-place, mask-driven ladder in plain PyTorch against the host
ladder); the rest check which buckets take the one-launch route and that
its rung tallies, folded at process_batch's one read, give the counters
the host ladder gives, with a stand-in for the card's launch.
"""
import collections

import numpy as np
import pytest
import torch

import npswf_tpu_torch.engine.pipeline as pipeline
from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.calibration import synthetic_calibration
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.core.params import batch_to_torch, calib_to_torch
from npswf_tpu_torch.fit import lm as tlm
from npswf_tpu_torch.fit import lm_kernel
from npswf_tpu_torch.fit.errors import error_model
from npswf_tpu_torch.fit.eval_kernel import pad_coeffs
from npswf_tpu_torch.models.waveform import get_model
from npswf_tpu_torch.ops.spline import spline_eval
from npswf_tpu_torch.utils.synthetic import make_events
import tests.torch_threads  # noqa: F401 (one torch thread a process)

GRID = dict(ncol=5, nlin=6)
SPLINE = "spline_ref_pallas"


def _inputs(cfg, cal, n, P, max_pulses, seed, dtype, jitter=3.5):
    """FitInputs of n lanes with known truth: 1..max_pulses spline pulses
    over noise 1.0, seeds jittered ``jitter`` bins inside the +-4-bin
    bounds (3.5: stage 1 leaves lanes and some components saturate)."""
    rng = np.random.default_rng(seed)
    T = cfg.ntime
    blocks = rng.integers(0, cfg.nblocks, n)
    x = np.arange(T, dtype=np.float64)
    sig = rng.uniform(-5, 5, n)[:, None] + rng.standard_normal((n, T))
    npul = rng.integers(1, max_pulses + 1, n)
    pmask = np.arange(P)[None, :] < npul[:, None]
    t_true = rng.uniform(-3, 3, (n, P))
    t_true[:, 1:] += rng.uniform(-25, 25, (n, P - 1))
    a_true = rng.uniform(40, 180, (n, P))
    coeffs = torch.as_tensor(cal.spline_coeffs[blocks])
    x0 = torch.as_tensor(cal.spline_x0[blocks])
    for p in range(max_pulses):
        arg = x[None, :] - t_true[:, p:p + 1]
        val = spline_eval(cfg, coeffs, x0, torch.as_tensor(arg)).numpy()
        gate = (arg > cfg.spline_gate_lo) & (arg < T - 1) & pmask[:, p:p + 1]
        sig += np.where(gate, a_true[:, p:p + 1] * val, 0.0)
    t_seed = np.where(pmask, t_true + jitter * rng.uniform(-1, 1, (n, P)),
                      0.0)
    a_seed = np.where(pmask, a_true * rng.uniform(0.6, 1.6, (n, P)), 0.0)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype)
    sig_t = t(sig)
    lo_b, hi_b = cfg.fit_lo_bin, cfg.fit_hi_bin
    return tlm.FitInputs(
        y=sig_t[:, lo_b:hi_b], sigma=error_model(cfg, sig_t)[:, lo_b:hi_b],
        coeffs=t(cal.spline_coeffs[blocks]), x0=t(cal.spline_x0[blocks]),
        t_seed=t(t_seed), a_seed=t(a_seed),
        ped_seed=t(sig[:, :cfg.ped_nsamples].mean(axis=1)),
        pulse_mask=torch.as_tensor(pmask),
        active=torch.ones(n, dtype=torch.bool))


def _ladder_args(cfg, inp, cut):
    """lm_ladder_kernel's arguments for ``inp``. With ``cut``, lanes reach
    every rung: lane i is inactive when i % 5 == 2, its stage-1 budget is
    i % 4 iterations and its stage-2 budget 0 when i % 7 == 3, 2 when
    i % 3 == 0."""
    lo, hi, p_seed, pm, u0, s1_budget, s2_budget = tlm._prepare(cfg, inp)
    active = inp.active
    if cut:
        idx = torch.arange(u0.shape[0])
        active = idx % 5 != 2
        s1_budget = (idx % 4).to(torch.int32)
        s2_budget = torch.where(idx % 7 == 3, 0, torch.where(
            idx % 3 == 0, 2, s2_budget)).to(torch.int32)
    return (pad_coeffs(inp.coeffs), inp.x0, inp.y, 1.0 / inp.sigma, u0, lo,
            hi, p_seed, pm, active,
            max(cfg.lm_max_iter_stage1, cfg.lm_stage1_wide), s1_budget,
            max(cfg.lm_max_iter_stage2, cfg.lm_stage2_wide), s2_budget)


def masked_ladder(cfg, coeffs_pad, x0, y, w, u0, lo, hi, p_seed, pm, active,
                  s1_cap, s1_budget, s2_cap, s2_budget):
    """The ladder launch's semantics in plain PyTorch, in place: every rung
    is lm_solve_plain over all lanes with the rung's lanes as ``active``
    (no gather, no test whether a rung has lanes), rows outside a rung
    zero as the host ladder leaves them. Returns lm_ladder_kernel's
    tuple."""
    def solve(u, act, max_iter, lam0, budget):
        return lm_kernel.lm_solve_plain(cfg, coeffs_pad, x0, y, w, u, lo, hi,
                                        p_seed, pm, act, max_iter, lam0,
                                        budget)
    u1, chi2_1, conv1, it1, edm1, _ = solve(u0, active, s1_cap,
                                            cfg.lm_lambda_init, s1_budget)
    failed1 = active & ~conv1
    tally = [failed1.sum()]
    u2, chi2_2, conv2, it2, _, _ = solve(u0, failed1, s2_cap,
                                         cfg.lm_lambda_init * 10.0, s2_budget)
    u2 = torch.where(failed1[:, None], u2, 0.0)
    chi2_2 = torch.where(failed1, chi2_2, 0.0)
    it2 = torch.where(failed1, it2, 0)
    if cfg.lm_stage3:
        for pullback in cfg.lm_stage3_pullbacks:
            failed2 = failed1 & ~conv2
            tally.append(failed2.sum())
            sinu1 = torch.sin(u1)
            u_pb = torch.where((torch.abs(sinu1) > 0.95) & pm,
                               torch.asin(float(pullback) * torch.sign(sinu1)),
                               u1)
            u3, chi2_3, conv3, it3, _, _ = solve(u_pb, failed2, s2_cap,
                                                 cfg.lm_lambda_init,
                                                 s2_budget)
            use3 = failed2 & conv3
            u2 = torch.where(use3[:, None], u3, u2)
            chi2_2 = torch.where(use3, chi2_3, chi2_2)
            conv2 = conv2 | use3
            it2 = it2 + torch.where(failed2, it3, 0)
    return (u1, chi2_1, conv1, it1, edm1, u2, chi2_2, conv2, it2,
            torch.stack(tally).to(torch.int32))


def _equal(x, y):
    """Bit-equal tensors (a NaN matching a NaN)."""
    return x.dtype == y.dtype and x.shape == y.shape and (
        torch.equal(x, y) or (x.is_floating_point() and bool(
            ((x == y) | (x.isnan() & y.isnan())).all())))


def _assert_same(a, b):
    assert len(a) == len(b) == 10
    for i, (x, y) in enumerate(zip(a, b)):
        assert _equal(x, y), i


@pytest.fixture(scope="module")
def cal():
    return synthetic_calibration(NPSConfig(), seed=1)


@pytest.mark.parametrize("stage3", [True, False], ids=["pullbacks", "stage2"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["fp64", "fp32"])
@pytest.mark.parametrize("P,max_pulses", [(2, 2), (4, 4), (12, 6)],
                         ids=["P2", "P4", "P12"])
def test_masked_rungs_equal_the_gathered_ladder(cal, P, max_pulses, dtype,
                                                stage3):
    """Each rung over every lane with its lanes as ``active`` equals the
    host's rung over the gathered lanes, bit for bit, on lanes that reach
    every rung (inactive lanes and budgets of 0 among them)."""
    cfg = NPSConfig(lm_stage3=stage3)
    inp = _inputs(cfg, cal, 40, P, max_pulses, 7 + P, dtype)
    args = _ladder_args(cfg, inp, cut=True)
    masked = masked_ladder(cfg, *args)
    gathered = lm_kernel.lm_ladder_plain(cfg, *args)
    _assert_same(masked, gathered)
    rungs = gathered[9].tolist()
    assert len(rungs) == tlm.ladder_rungs(cfg) == (3 if stage3 else 1)
    assert all(rungs), "every rung retries lanes"
    # lanes that enter no rung hold the host ladder's zeros
    out = ~(args[9] & ~gathered[2])
    assert not gathered[7][out].any() and not gathered[8][out].any()
    assert not gathered[5][out].any() and not gathered[6][out].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["fp64", "fp32"])
def test_an_empty_rung_is_result_neutral(cal, dtype):
    """Full budgets on lanes the stage-2 restart (nearly) converges: the
    last pull-back rung gets no lane (the host ladder stops before it), and
    the in-place rung, run regardless, changes nothing."""
    cfg = NPSConfig()
    inp = _inputs(cfg, cal, 24, 2, 2, 5, dtype, jitter=1.0)
    args = list(_ladder_args(cfg, inp, cut=False))
    args[11] = torch.where(torch.arange(24) % 2 == 0, 0, args[11])
    masked = masked_ladder(cfg, *args)
    gathered = lm_kernel.lm_ladder_plain(cfg, *args)
    _assert_same(masked, gathered)
    rungs = gathered[9].tolist()
    assert rungs[0] >= 12 and rungs[-1] == 0
    # nothing to retry: every rung empty
    args[11] = torch.full((24,), cfg.lm_max_iter_stage1, dtype=torch.int32)
    args[9] = torch.zeros(24, dtype=torch.bool)
    _assert_same(masked_ladder(cfg, *args),
                 lm_kernel.lm_ladder_plain(cfg, *args))


@pytest.mark.parametrize("case,fused", [
    ("spline P=2", True), ("spline P=4", True), ("spline P=12", True),
    ("spline P=2, 9 pull-backs", True), ("spline P=2 on the CPU", False),
    ("gaussian P=2", False), ("use_fused_system", False),
    ("use_fused_neq", False), ("use_pallas_lm off", False),
    ("P=16 (wide unit)", False), ("plain", False)])
def test_which_buckets_take_the_ladder_launch(monkeypatch, cal, case, fused):
    """The one-launch ladder serves the spline model where K3 does on the
    card at a compiled width, whatever the number of pull-backs; lanes on
    the CPU, the generic routes, the fused flags, the wide unit and
    plain=True run the host ladder. Each fit counts its route once; the
    launch hands back its rung tallies on the device, the host ladder
    counts its rungs itself."""
    P = {"spline P=4": 4, "spline P=12": 12,
         "P=16 (wide unit)": 16}.get(case, 2)
    cfg = NPSConfig(lm_max_iter_stage1=2, lm_stage1_wide=2,
                    lm_max_iter_stage2=2, lm_stage2_wide=2,
                    pallas_lm_max_pulses=24)
    model = SPLINE
    if case == "gaussian P=2":
        cfg, model = cfg.replace(model_aux=(("width", 3.5),)), "gaussian"
    elif case.startswith("use_fused"):
        cfg = cfg.replace(**{case: True})
    elif case == "use_pallas_lm off":
        cfg = cfg.replace(use_pallas_lm=False)
    elif case == "spline P=2, 9 pull-backs":
        cfg = cfg.replace(lm_stage3_pullbacks=tuple(
            0.9 - 0.05 * i for i in range(9)))
    on_card = case not in ("spline P=2 on the CPU", "plain")
    assert tlm._ladder_fused(cfg, get_model(model), P,
                             torch.device("cuda")) is (fused or not on_card)
    assert not tlm._ladder_fused(cfg, get_model(model), P,
                                 torch.device("cpu"))
    if case != "spline P=2 on the CPU":
        _stand_in_card(monkeypatch, [])
    inp = _inputs(cfg, cal, 6, P, min(P, 3), 3, torch.float64)
    kernels.reset_counts()
    res = tlm.fit_waveforms(cfg, inp, model, plain=case == "plain")
    counts = dict(kernels.counts)
    kernels.reset_counts()
    route = "fit.ladder_fused" if fused else "fit.ladder_host"
    other = "fit.ladder_host" if fused else "fit.ladder_fused"
    assert counts.get(route) == 1 and other not in counts
    failed1 = int((inp.active & ~res.converged_stage1).sum())
    if fused:
        assert res.rung_lanes.shape == (tlm.ladder_rungs(cfg),)
        assert res.rung_lanes.dtype == torch.int32
        # the stage-2 restart retries every lane stage 1 left unconverged
        assert int(res.rung_lanes[0]) == failed1 > 0
        # the caller folds them
        assert "fit.rungs" not in counts and "fit.retry_lanes" not in counts
    else:
        assert res.rung_lanes is None
        assert counts["fit.rungs"] >= 1
        assert counts["fit.retry_lanes"] >= failed1 > 0


def _batch(cfg, seed=5, n_events=4):
    cal = synthetic_calibration(cfg, seed=1)
    truth = make_events(cfg, cal, n_events, occupancy=0.6, max_pulses=4,
                        pileup_prob=0.6, seed=seed)
    corr = np.random.default_rng(seed).uniform(-2, 2, n_events)
    calib = calib_to_torch(cal.device_arrays(cfg), "cpu", torch.float64)
    batch = batch_to_torch(truth.signal, truth.pres, corr, "cpu",
                           torch.float64)
    return calib, batch


def _stand_in_card(monkeypatch, launches):
    """lm_ladder_kernel as the card runs it, on the CPU: lanes taken as on
    the card, and the masked ladder, counted as one K3 launch, with what its
    plain arithmetic counts kept apart (a launch counts nothing but
    itself), its tallies a device tensor the host does not read."""
    route = tlm._ladder_fused
    monkeypatch.setattr(tlm, "_ladder_fused", lambda cfg, model, P, device:
                        route(cfg, model, P, torch.device("cuda")))

    def card(cfg, *args):
        with kernels.recording():
            out = masked_ladder(cfg, *args)
        kernels.count_launch(kernels.LM_SOLVE)
        launches.append(int(args[9].sum()))
        return out
    monkeypatch.setattr(lm_kernel, "lm_ladder_kernel", card)


@pytest.mark.parametrize("stage3", [False, True], ids=["stage2", "ladder"])
def test_folded_tallies_count_what_the_host_ladder_counts(monkeypatch,
                                                          stage3):
    """process_batch on the one-launch route (the card's launch stood in
    for) and on the host route (plain=True) on the same batch: the same
    outputs, the same fit.rungs, fit.retry_lanes and fit.stage1_lanes; on
    the one-launch route one launch and one fit.ladder_fused a fitted
    bucket, no sync.fit.* site and one sync besides the buckets' (the
    tallies' one read), on the host route fit.ladder_host."""
    cfg = NPSConfig(**GRID, compute_dtype="float64", lm_max_iter_stage1=2,
                    lm_stage1_wide=2, lm_stage3=stage3,
                    **(dict(lm_max_iter_stage2=1, lm_stage2_wide=1)
                       if stage3 else {}))
    calib, batch = _batch(cfg)
    kernels.reset_counts()
    host = pipeline.process_batch(cfg, calib, batch, plain=True)
    host_counts = dict(kernels.counts)
    launches = []
    _stand_in_card(monkeypatch, launches)
    kernels.reset_counts()
    fused = pipeline.process_batch(cfg, calib, batch)
    counts = dict(kernels.counts)
    n_launch = kernels.launches[kernels.LM_SOLVE]
    kernels.reset_counts()

    for name in pipeline.PipelineOutput._fields:
        assert _equal(getattr(fused, name), getattr(host, name)), name
    fitted = host_counts["fit.ladder_host"]
    assert fitted == len(launches) == n_launch == counts["fit.ladder_fused"]
    assert fitted >= 2 and all(launches)
    assert "fit.ladder_host" not in counts
    assert "fit.ladder_fused" not in host_counts
    for name in ("fit.rungs", "fit.retry_lanes", "fit.stage1_lanes"):
        assert counts[name] == host_counts[name], name
    assert counts["fit.rungs"] == (fitted * (1 + len(cfg.lm_stage3_pullbacks))
                                   if stage3 else fitted)
    sites = {k for k in counts if k.startswith("sync.")}
    assert sites == {"sync.engine.bucket_sizes", "sync.engine.rung_tallies"}
    assert counts["sync.engine.bucket_sizes"] == 1
    assert counts["sync.engine.rung_tallies"] == 1
    assert {"sync.fit.retry_select", "sync.fit.ladder_any"} <= set(host_counts)


def test_the_ladder_launch_is_one_span_per_fitted_bucket(monkeypatch):
    """Under torch.profiler the one-launch route shows one npswf.fit.ladder
    range inside each fitted bucket's npswf.engine.bucket, and no
    npswf.fit.retry."""
    cfg = NPSConfig(**GRID, compute_dtype="float64", lm_max_iter_stage1=2,
                    lm_stage1_wide=2)
    calib, batch = _batch(cfg)
    launches = []
    _stand_in_card(monkeypatch, launches)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        pipeline.process_batch(cfg, calib, batch)
    kernels.reset_counts()
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith("npswf."):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    assert "npswf.fit.retry" not in ranges
    assert "npswf.fit.stage1" not in ranges
    ladders = ranges["npswf.fit.ladder"]
    assert len(ladders) == len(launches) >= 2
    for start, end in ladders:
        assert sum(a <= start <= end <= b
                   for a, b in ranges["npswf.engine.bucket"]) == 1
