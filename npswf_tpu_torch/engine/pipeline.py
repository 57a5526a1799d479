"""The batched event pipeline on one device.

Counterpart of npswf_tpu/engine/pipeline.py::process_batch (the
reference's ``analyze``, TEST_2.C:540-1300): one event batch runs as

    signal [E, B, T] --> matched filter + peak search (all E*B lanes)
                     --> 3x3 cluster gate
                     --> fit lanes split into pulse-count buckets
                     --> bounded LM fit with the retry ladder
                     --> output-path resolution + time conversion
                     --> diagnostics

with the reference's output paths: a cluster-gate failure keeps the raw
search values (times in bins, chi2 = -100); a failed fit converts the seed
times to ns and keeps the seed amplitudes (chi2 = -100); a converged fit
reports fitted amplitudes, t_fit*dt + corr_time_HMS - cortime -
timerefacc*dt and chi2/ndf. timewf/amplwf pick the pulse with |time|
closest to zero, first on ties; h1time/h2time are filled for gate-passed
pulses with final amplitude > 20.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.engine.diagnostics import block_diagnostics
from npswf_tpu_torch.fit.errors import error_model
from npswf_tpu_torch.fit.lm import FitInputs, fit_waveforms
from npswf_tpu_torch.ops.cluster_gate import cluster_gate
from npswf_tpu_torch.ops.peak_search import find_pulses


class EventBatch(NamedTuple):
    """Inputs for one batch of events."""
    signal: torch.Tensor          # [E, B, T] waveforms
    pres: torch.Tensor            # [E, B] bool — block present in the readout
    corr_time_HMS: torch.Tensor   # [E] HMS timing correction
    evt: torch.Tensor             # [E] global event numbers
    runnum: torch.Tensor          # [E] run numbers
    # [E, B] per-block baseline from the decoder (min over the samples
    # actually read); None for dense batches, where min over T is the same
    minsignal: Optional[torch.Tensor] = None


class PipelineOutput(NamedTuple):
    """Fixed-shape per-event outputs (same fields as the reference package)."""
    wfnpulse: torch.Tensor        # [E, B] i32
    wftime: torch.Tensor          # [E, B, P] — ns (fit paths) or bins (gate fail)
    wfampl: torch.Tensor          # [E, B, P]
    pulse_valid: torch.Tensor     # [E, B, P] bool
    chi2: torch.Tensor            # [E, B] chi2/ndf or -100
    timewf: torch.Tensor          # [E, B] closest-to-zero pulse time (or -100)
    amplwf: torch.Tensor          # [E, B] its amplitude (or -100)
    pedwf: torch.Tensor           # [E, B] fitted pedestal (seed if unfitted)
    gate: torch.Tensor            # [E, B] bool — cluster gate decision
    fit_converged: torch.Tensor   # [E, B] bool
    fit_n_iter: torch.Tensor      # [E, B] i32 — LM iterations spent (0 = not fitted)
    h1time: torch.Tensor          # [E, B, P] h1 entries (valid via h_mask)
    h2time: torch.Tensor          # [E, B, P]
    h_mask: torch.Tensor          # [E, B, P] bool
    ampl: torch.Tensor            # [E, B] max sample (diagnostics)
    ener: torch.Tensor            # [E, B]
    integ: torch.Tensor           # [E, B]
    bkg: torch.Tensor             # [E, B]
    noise: torch.Tensor           # [E, B]
    enertot: torch.Tensor         # [E]
    integtot: torch.Tensor        # [E]
    n_fit_success: torch.Tensor   # [] i32 — batch totals (ref atomics :61-62)
    n_fit_failure: torch.Tensor   # [] i32
    n_fit_dropped: torch.Tensor   # [] i32 — lanes beyond fit_capacity
    n_high_pulse: torch.Tensor    # [] i32 — lanes with npulse > maxwfpulses-2
    n_search_dropped: torch.Tensor  # [] i32 — present lanes beyond search_capacity
    search_overflow: torch.Tensor   # [E, B] bool — present lanes not searched


def _front(mask: torch.Tensor) -> torch.Tensor:
    """Lane order with the masked lanes first, each group in index order
    (a stable argsort of ~mask)."""
    return torch.cat([torch.nonzero(mask).squeeze(1),
                      torch.nonzero(~mask).squeeze(1)])


def _slot(mask: torch.Tensor) -> torch.Tensor:
    """Each lane's position in ``_front(mask)``, in closed form."""
    m = mask.to(torch.int64)
    nm = m.sum()
    return torch.where(mask, torch.cumsum(m, 0) - 1,
                       nm + torch.cumsum(1 - m, 0) - 1)


def process_batch(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                  batch: EventBatch, block_axis: Optional[str] = None,
                  block_shards: int = 1, reduce_axes: Tuple[str, ...] = (),
                  plain: bool = False) -> PipelineOutput:
    """Run the full pipeline on one event batch on one device.

    ``calib`` is ``core.params.calib_to_torch`` of the calibration arrays.
    With ``plain=True`` every kernel's plain PyTorch version runs instead.
    """
    if block_axis is not None or block_shards != 1 or reduce_axes:
        raise NotImplementedError(
            "process_batch runs on one device: the torch.distributed mesh is "
            "in ROADMAP Queue 1")
    signal = batch.signal
    E, B, T = signal.shape
    P = cfg.maxwfpulses
    dtype, dev = signal.dtype, signal.device
    N = E * B

    preswf = calib["preswf"]
    timeref = calib["timeref"].to(dtype)
    cortime = calib["cortime"].to(dtype)
    timerefacc = torch.as_tensor(calib["timerefacc"], dtype=dtype, device=dev)
    coeffs = calib["spline_coeffs"].to(dtype)
    x0 = calib["spline_x0"].to(dtype)
    kern = calib["mfkern_rev"].to(dtype)
    mfint = calib["mfint"].to(dtype)

    present = batch.pres.to(torch.bool) & preswf[None, :]       # [E, B]
    flat_sig = signal.reshape(N, T)
    flat_present = present.reshape(N)
    if batch.minsignal is not None:
        minsignal = batch.minsignal.to(dtype).reshape(N)
    else:
        minsignal = flat_sig.amin(dim=1)
    kern_flat = kern[None].expand(E, B, cfg.mfwidth).reshape(N, -1)
    mfint_flat = mfint[None].expand(E, B).reshape(N)

    # ---- peak search (optionally on the present lanes only) ----------
    cap_s = min(cfg.search_capacity, N) if cfg.search_capacity > 0 else 0
    n_search_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    search_overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
    if 0 < cap_s < N:
        sel_s = _front(flat_present)[:cap_s]
        ps_c = find_pulses(cfg, flat_sig[sel_s], minsignal[sel_s],
                           kern_flat[sel_s], mfint_flat[sel_s],
                           flat_present[sel_s], plain=plain)
        pos_s = _slot(flat_present)
        searched = flat_present & (pos_s < cap_s)
        posc_s = torch.clamp(pos_s, max=cap_s - 1)
        npulse = torch.where(searched, ps_c.npulse[posc_s], 0).to(torch.int32)
        seed_t_abs = torch.where(searched[:, None], ps_c.times[posc_s], 0.0)
        seed_a = torch.where(searched[:, None], ps_c.amps[posc_s], 0.0)
        pulse_mask = ps_c.valid[posc_s] & searched[:, None]
        search_overflow = flat_present & ~searched
        n_search_dropped = search_overflow.sum().to(torch.int32)
    else:
        ps = find_pulses(cfg, flat_sig, minsignal, kern_flat, mfint_flat,
                         flat_present, plain=plain)
        npulse, seed_t_abs, seed_a, pulse_mask = (ps.npulse, ps.times,
                                                  ps.amps, ps.valid)

    # ---- cluster gate ------------------------------------------------
    gate = cluster_gate(cfg, signal, timeref, timerefacc).reshape(N)
    fit_active = flat_present & gate & (npulse > 0)

    # ---- pulse-count buckets: narrow (<= fit_small_pulses), middle
    #      (<= fit_mid_pulses) and wide parameter vectors ---------------
    M = 1 + 2 * P
    Ps = max(1, min(cfg.fit_small_pulses, P))
    cap_all = min(cfg.fit_capacity if cfg.fit_capacity > 0 else N, N)
    small_active = fit_active & (npulse <= Ps)
    big_active = fit_active & (npulse > Ps)
    blocks_flat = torch.arange(B, device=dev).repeat(E)
    ped_seed_all = flat_sig[:, :cfg.ped_nsamples].mean(dim=1)   # ref :672-676

    params = torch.zeros((N, M), dtype=dtype, device=dev)
    chi2_ndf = torch.zeros((N,), dtype=dtype, device=dev)
    converged = torch.zeros((N,), dtype=torch.bool, device=dev)
    n_iter_lanes = torch.zeros((N,), dtype=torch.int32, device=dev)
    fitted = torch.zeros((N,), dtype=torch.bool, device=dev)
    n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
    buckets = [(small_active, cap_all, Ps)]
    if P > Ps:
        # fit_capacity == 0 means "fit every block": the wide bucket is
        # uncapped too
        cap_big = N if cfg.fit_capacity <= 0 else max(
            min(N, 256), cap_all // max(cfg.fit_big_frac, 1))
        Pm = min(cfg.fit_mid_pulses, P)
        if Pm > Ps:
            mid_active = big_active & (npulse <= Pm)
            big_active = big_active & (npulse > Pm)
            buckets.append((mid_active, cap_big, Pm))
        buckets.append((big_active, cap_big, P))
    model_name = ("spline_ref_pallas" if cfg.model_name == "spline_ref"
                  else cfg.model_name)
    for mask, cap_b, Pb in buckets:
        n_mask = int(mask.sum())      # host sync: an empty bucket costs nothing
        n_dropped = n_dropped + max(n_mask - cap_b, 0)
        if n_mask == 0:
            continue
        # capacity covers every lane: fit in place, the bucket mask as
        # `active` (no compaction permutation); else the first cap_b lanes
        in_place = cap_b >= N
        lanes = slice(None) if in_place else _front(mask)[:cap_b]
        sel_sig = flat_sig[lanes]
        sel_blocks = blocks_flat[lanes]
        sel_err = error_model(cfg, sel_sig)
        inp = FitInputs(
            y=sel_sig[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
            sigma=sel_err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
            coeffs=coeffs[sel_blocks], x0=x0[sel_blocks],
            t_seed=seed_t_abs[lanes][:, :Pb] - timeref[sel_blocks][:, None],
            a_seed=seed_a[lanes][:, :Pb],
            ped_seed=ped_seed_all[lanes],
            pulse_mask=pulse_mask[lanes][:, :Pb],
            active=mask[lanes],
            timeref=timeref[sel_blocks])
        fres = fit_waveforms(cfg, inp, model_name, plain=plain)
        pf = torch.cat([fres.params,
                        torch.zeros((fres.params.shape[0], 2 * (P - Pb)),
                                    dtype=dtype, device=dev)], dim=1)
        if in_place:
            infit = mask
            posc = slice(None)
        else:
            # un-permute by gather: lane i sits at _slot(mask)[i]
            pos = _slot(mask)
            infit = mask & (pos < cap_b)
            posc = torch.clamp(pos, max=cap_b - 1)
        params = torch.where(infit[:, None], pf[posc], params)
        chi2_ndf = torch.where(infit, fres.chi2_ndf[posc], chi2_ndf)
        converged = converged | (fres.converged[posc] & infit)
        n_iter_lanes = torch.where(infit, fres.n_iter[posc], n_iter_lanes)
        fitted = fitted | infit

    # ---- output-path resolution --------------------------------------
    cortime_b = cortime[blocks_flat]
    corr = batch.corr_time_HMS.to(dtype).repeat_interleave(B)   # [N]
    t_param = params[:, 1::2]                                   # [N, P] rel bins
    a_param = params[:, 2::2]
    seed_t_rel = seed_t_abs - timeref[blocks_flat][:, None]
    t_rel = torch.where(fitted[:, None], t_param, seed_t_rel)
    a_fin = torch.where((fitted & converged)[:, None], a_param, seed_a)
    pedwf = torch.where(fitted, params[:, 0], ped_seed_all)

    conv_term = (corr - cortime_b - timerefacc * cfg.dt)[:, None]
    t_ns = t_rel * cfg.dt + conv_term                           # ref :782-785
    # gate-fail lanes keep raw bin-unit times; slots beyond npulse are zero
    wftime = torch.where(pulse_mask,
                         torch.where(fitted[:, None], t_ns, seed_t_abs), 0.0)
    wfampl = torch.where(pulse_mask, a_fin, 0.0)
    chi2 = torch.where(fitted & converged, chi2_ndf, -100.0)

    # timewf/amplwf: |time| closest to zero among valid pulses, first on tie
    abs_t = torch.where(pulse_mask, torch.abs(wftime), float("inf"))
    best = torch.argmin(abs_t, dim=1, keepdim=True)
    has = fitted & (npulse > 0)
    timewf = torch.where(has, torch.gather(wftime, 1, best)[:, 0], -100.0)
    amplwf = torch.where(has, torch.gather(wfampl, 1, best)[:, 0], -100.0)

    # h1/h2 entries (ref :988-997): gate-passed lanes, final amplitude > 20
    h_mask = fitted[:, None] & pulse_mask & (wfampl > cfg.amp_h12_thres)
    h1 = t_rel - timerefacc + corr[:, None] / cfg.dt            # ref :994

    diag = block_diagnostics(cfg, signal)
    n_succ = (fitted & converged).sum().to(torch.int32)
    n_fail = (fitted & ~converged).sum().to(torch.int32)
    n_high = (flat_present & (npulse > P - 2)).sum().to(torch.int32)

    return PipelineOutput(
        wfnpulse=npulse.reshape(E, B),
        wftime=wftime.reshape(E, B, P),
        wfampl=wfampl.reshape(E, B, P),
        pulse_valid=pulse_mask.reshape(E, B, P),
        chi2=chi2.reshape(E, B),
        timewf=timewf.reshape(E, B),
        amplwf=amplwf.reshape(E, B),
        pedwf=pedwf.reshape(E, B),
        gate=gate.reshape(E, B),
        fit_converged=(fitted & converged).reshape(E, B),
        fit_n_iter=torch.where(fitted, n_iter_lanes, 0).reshape(E, B),
        h1time=h1.reshape(E, B, P),
        h2time=wftime.reshape(E, B, P),
        h_mask=h_mask.reshape(E, B, P),
        ampl=diag["ampl"], ener=diag["ener"], integ=diag["integ"],
        bkg=diag["bkg"], noise=diag["noise"],
        enertot=diag["enertot"], integtot=diag["integtot"],
        n_fit_success=n_succ,
        n_fit_failure=n_fail,
        n_fit_dropped=n_dropped,
        n_high_pulse=n_high,
        n_search_dropped=n_search_dropped,
        search_overflow=search_overflow.reshape(E, B))
