"""The batched event pipeline on one device, or on one rank of a mesh.

Counterpart of npswf_tpu/engine/pipeline.py::process_batch (the
reference's ``analyze``, TEST_2.C:540-1300): one event batch runs as

    signal [E, B, T] --> matched filter + peak search (all E*B lanes)
                     --> 3x3 cluster gate
                     --> fit lanes split into pulse-count buckets
                     --> bounded LM fit with the retry ladder
                     --> output-path resolution + time conversion
                     --> diagnostics

as two halves on the device around one read of the bucket sizes: the
search and the gate (``_search_and_gate``), then the fits, the resolution
and the diagnostics (``_fit_and_resolve``). On the card they run as CUDA
graph replays (``engine/graphs.py``) where ``graph_route`` admits the
call; elsewhere the eager body (``process_batch_eager``) issues them op
by op. The reference's output paths: a cluster-gate failure keeps the raw
search values (times in bins, chi2 = -100); a failed fit converts the seed
times to ns and keeps the seed amplitudes (chi2 = -100); a converged fit
reports fitted amplitudes, t_fit*dt + corr_time_HMS - cortime -
timerefacc*dt and chi2/ndf. timewf/amplwf pick the pulse with |time|
closest to zero, first on ties; h1time/h2time are filled for gate-passed
pulses with final amplitude > 20.

Below it, counterparts of the JAX package's writer packets and chains
(npswf_tpu/engine/pipeline.py:455-865): ``pack_for_writer`` and
``flatten_packet`` (the dense packet), ``flatten_packet_slab`` (present
lanes only), their host inverses ``unflatten_packet*`` (numpy, copied),
``make_pipeline_packed`` and its chain over k batches.
"""
from __future__ import annotations

import functools
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from npswf_tpu_torch import kernels
from npswf_tpu_torch.core.config import NPSConfig
from npswf_tpu_torch.engine.diagnostics import block_diagnostics
from npswf_tpu_torch.fit.errors import error_model
from npswf_tpu_torch.fit.lm import (FitInputs, _ladder_fused, count_rung_lanes,
                                    fit_waveforms)
from npswf_tpu_torch.models.waveform import get_model
from npswf_tpu_torch.ops.cluster_gate import cluster_gate
from npswf_tpu_torch.ops.peak_search import find_pulses
from npswf_tpu_torch.parallel.axis import Axis, require_axis
from npswf_tpu_torch.utils.timers import span


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


def _slot(mask: torch.Tensor) -> torch.Tensor:
    """Each lane's position in ``_front(mask)``, in closed form."""
    m = mask.to(torch.int64)
    nm = m.sum()
    return torch.where(mask, torch.cumsum(m, 0) - 1,
                       nm + torch.cumsum(1 - m, 0) - 1)


def _front(mask: torch.Tensor, slot: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Lane order with the masked lanes first, each group in index order
    (a stable argsort of ~mask): each lane's index scattered to its place
    in that order (``slot``, else ``_slot(mask)``), with no host sync."""
    lanes = torch.arange(mask.shape[0], device=mask.device)
    return torch.empty_like(lanes).scatter_(
        0, _slot(mask) if slot is None else slot, lanes)


def _compact(mask: torch.Tensor, cap: int):
    """A stage's lanes under a capacity of ``cap``: (the lanes to hand it,
    each lane's row in its answers, the lanes it served). The first ``cap``
    masked lanes go in, in index order (``_front``), and each lane reads
    its answer from its place in that order (``_slot``, clamped to the
    answers' rows); a capacity that covers every lane serves them in
    place."""
    if cap >= mask.shape[0]:
        return slice(None), slice(None), mask
    pos = _slot(mask)
    return (_front(mask, pos)[:cap], torch.clamp(pos, max=cap - 1),
            mask & (pos < cap))


# the calibration arrays a call reads
CALIB_KEYS = ("preswf", "timeref", "cortime", "timerefacc", "spline_coeffs",
              "spline_x0", "mfkern_rev", "mfint")


def _calib_tensors(calib: Dict[str, torch.Tensor], dtype: torch.dtype,
                   dev: torch.device) -> Dict[str, torch.Tensor]:
    """The calibration as a call reads it: floating arrays in the batch's
    type, ``timerefacc`` a 0-d tensor on the batch's device."""
    return {"preswf": calib["preswf"],
            "timeref": calib["timeref"].to(dtype),
            "cortime": calib["cortime"].to(dtype),
            "timerefacc": torch.as_tensor(calib["timerefacc"], dtype=dtype,
                                          device=dev),
            "coeffs": calib["spline_coeffs"].to(dtype),
            "x0": calib["spline_x0"].to(dtype),
            "kern": calib["mfkern_rev"].to(dtype),
            "mfint": calib["mfint"].to(dtype)}


def _bucket_widths(cfg: NPSConfig) -> Tuple[int, ...]:
    """The pulse-count buckets' parameter widths: narrow (<=
    fit_small_pulses), middle (<= fit_mid_pulses) and wide."""
    P = cfg.maxwfpulses
    Ps = max(1, min(cfg.fit_small_pulses, P))
    if P == Ps:
        return (Ps,)
    Pm = min(cfg.fit_mid_pulses, P)
    return (Ps, Pm, P) if Pm > Ps else (Ps, P)


def _bucket_caps(cfg: NPSConfig, N: int) -> Tuple[int, ...]:
    """Each bucket's capacity over N lanes; fit_capacity == 0 means "fit
    every block": the wider buckets are uncapped too."""
    cap_all = min(cfg.fit_capacity if cfg.fit_capacity > 0 else N, N)
    cap_big = N if cfg.fit_capacity <= 0 else max(
        min(N, 256), cap_all // max(cfg.fit_big_frac, 1))
    return (cap_all,) + (cap_big,) * (len(_bucket_widths(cfg)) - 1)


def _fit_model(cfg: NPSConfig) -> str:
    return ("spline_ref_pallas" if cfg.model_name == "spline_ref"
            else cfg.model_name)


def graph_route(cfg: NPSConfig, device: torch.device,
                block_axis: Optional[Axis] = None,
                reduce_axes: Tuple[Axis, ...] = (),
                plain: bool = False) -> bool:
    """Whether process_batch issues a call's device work as CUDA graph
    replays (``engine/graphs.py``): the batch is on the card, ``plain`` is
    off, the call is no mesh rank's (no ``block_axis``, no
    ``reduce_axes``) and K3 fits every bucket in one launch
    (``fit.lm._ladder_fused``). Every other call runs the eager body."""
    if device.type != "cuda" or plain or block_axis is not None or reduce_axes:
        return False
    model = get_model(_fit_model(cfg))
    return all(_ladder_fused(cfg, model, Pb, device)
               for Pb in _bucket_widths(cfg))


class _Front(NamedTuple):
    """What the search and the gate hand the fits (per lane unless said)."""
    npulse: torch.Tensor            # [N] i32
    seed_t_abs: torch.Tensor        # [N, P] seed times, absolute bins
    seed_a: torch.Tensor            # [N, P] seed amplitudes
    pulse_mask: torch.Tensor        # [N, P] bool
    search_overflow: torch.Tensor   # [N] bool
    n_search_dropped: torch.Tensor  # [] i32
    gate: torch.Tensor              # [N] bool
    flat_present: torch.Tensor      # [N] bool
    buckets: Tuple[torch.Tensor, ...]  # [N] bool, each bucket's lanes
    sizes: torch.Tensor             # [buckets] i64: their lane counts
    n_dropped: torch.Tensor         # [] i32: lanes beyond the capacities


def _search_and_gate(cfg: NPSConfig, cal: Dict[str, torch.Tensor],
                     batch: EventBatch, block_axis: Optional[Axis],
                     block_shards: int, plain: bool) -> _Front:
    """The call's first half, all on the device: the peak search (with its
    lane compaction under ``search_capacity``), the cluster gate, the
    pulse-count buckets and their lane counts. ``cal`` is
    ``_calib_tensors``'."""
    signal = batch.signal
    E, B, T = signal.shape
    dtype, dev = signal.dtype, signal.device
    N = E * B

    present = batch.pres.to(torch.bool) & cal["preswf"][None, :]  # [E, B]
    flat_sig = signal.reshape(N, T)
    flat_present = present.reshape(N)
    if batch.minsignal is not None:
        minsignal = batch.minsignal.to(dtype).reshape(N)
    else:
        minsignal = flat_sig.amin(dim=1)
    kern_flat = cal["kern"][None].expand(E, B, cfg.mfwidth).reshape(N, -1)
    mfint_flat = cal["mfint"][None].expand(E, B).reshape(N)

    # ---- peak search (optionally on the present lanes only) --------------
    with span("engine.search"):
        cap_s = min(cfg.search_capacity, N) if cfg.search_capacity > 0 else 0
        n_search_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        search_overflow = torch.zeros((N,), dtype=torch.bool, device=dev)
        compact = 0 < cap_s < N
        kernels.count("engine.search_lanes", cap_s if compact else N)
        if compact:
            # the compaction: the first cap_s present lanes gathered in,
            # their answers gathered back to every lane
            with span("engine.search.compact"):
                sel_s, posc_s, searched = _compact(flat_present, cap_s)
                lanes_s = (flat_sig[sel_s], minsignal[sel_s],
                           kern_flat[sel_s], mfint_flat[sel_s],
                           flat_present[sel_s])
            ps_c = find_pulses(cfg, *lanes_s, plain=plain)
            del lanes_s  # the gathered lanes are the search's alone
            with span("engine.search.compact"):
                npulse = torch.where(searched, ps_c.npulse[posc_s],
                                     0).to(torch.int32)
                seed_t_abs = torch.where(searched[:, None],
                                         ps_c.times[posc_s], 0.0)
                seed_a = torch.where(searched[:, None], ps_c.amps[posc_s],
                                     0.0)
                pulse_mask = ps_c.valid[posc_s] & searched[:, None]
                search_overflow = flat_present & ~searched
                n_search_dropped = search_overflow.sum().to(torch.int32)
        else:
            ps = find_pulses(cfg, flat_sig, minsignal, kern_flat, mfint_flat,
                             flat_present, plain=plain)
            npulse, seed_t_abs, seed_a, pulse_mask = (ps.npulse, ps.times,
                                                      ps.amps, ps.valid)

    # ---- cluster gate, and the fit lanes in pulse-count buckets ----------
    with span("engine.gate"):
        gate = cluster_gate(cfg, signal, cal["timeref"], cal["timerefacc"],
                            block_axis, block_shards).reshape(N)
        fit_active = flat_present & gate & (npulse > 0)
        widths = _bucket_widths(cfg)
        buckets = [fit_active & (npulse <= widths[0])]
        if len(widths) > 1:
            big = fit_active & (npulse > widths[0])
            if len(widths) == 3:
                buckets.append(big & (npulse <= widths[1]))
                big = big & (npulse > widths[1])
            buckets.append(big)
        sizes = torch.stack(buckets).sum(dim=1)
        n_dropped = torch.zeros((), dtype=torch.int32, device=dev)
        for i, cap in enumerate(_bucket_caps(cfg, N)):
            if cap < N:
                n_dropped = n_dropped + torch.clamp(
                    sizes[i] - cap, min=0).to(torch.int32)
    return _Front(npulse, seed_t_abs, seed_a, pulse_mask, search_overflow,
                  n_search_dropped, gate, flat_present, tuple(buckets), sizes,
                  n_dropped)


def _bucket_sizes(cfg: NPSConfig, sizes: torch.Tensor,
                  N: int) -> Tuple[bool, ...]:
    """The call's one read of its buckets' lane counts (a host sync):
    which buckets have lanes to fit; the lanes they fit, up to their
    capacities, count in ``fit.stage1_lanes``."""
    n = sizes.tolist()
    kernels.count("sync.engine.bucket_sizes")
    lanes = sum(min(k, cap) for k, cap in zip(n, _bucket_caps(cfg, N)))
    if lanes:
        kernels.count("fit.stage1_lanes", lanes)
    return tuple(k > 0 for k in n)


def _fit_and_resolve(cfg: NPSConfig, cal: Dict[str, torch.Tensor],
                     batch: EventBatch, front: _Front,
                     filled: Tuple[bool, ...], block_axis: Optional[Axis],
                     plain: bool) -> Tuple[PipelineOutput, Optional[torch.Tensor]]:
    """The call's second half, all on the device: the fits of the buckets
    ``filled`` names (those with lanes, ``_bucket_sizes``), the output-path
    resolution and the diagnostics. Returns the output and the rung tallies of the fits K3
    ran whole, on the device (None where none did)."""
    signal = batch.signal
    E, B, T = signal.shape
    P = cfg.maxwfpulses
    dtype, dev = signal.dtype, signal.device
    N = E * B
    flat_sig = signal.reshape(N, T)
    timeref, cortime = cal["timeref"], cal["cortime"]
    timerefacc = cal["timerefacc"]
    npulse, seed_t_abs = front.npulse, front.seed_t_abs
    seed_a, pulse_mask = front.seed_a, front.pulse_mask
    flat_present = front.flat_present

    M = 1 + 2 * P
    blocks_flat = torch.arange(B, device=dev).repeat(E)
    ped_seed_all = flat_sig[:, :cfg.ped_nsamples].mean(dim=1)   # ref :672-676
    params = torch.zeros((N, M), dtype=dtype, device=dev)
    chi2_ndf = torch.zeros((N,), dtype=dtype, device=dev)
    converged = torch.zeros((N,), dtype=torch.bool, device=dev)
    n_iter_lanes = torch.zeros((N,), dtype=torch.int32, device=dev)
    fitted = torch.zeros((N,), dtype=torch.bool, device=dev)
    rung_lanes = []   # the one-launch ladders' rung tallies, on the device
    model_name = _fit_model(cfg)
    for mask, cap_b, Pb, has_lanes in zip(front.buckets, _bucket_caps(cfg, N),
                                          _bucket_widths(cfg), filled):
        with span("engine.bucket"):
            if not has_lanes:      # an empty bucket costs nothing
                continue
            # capacity covers every lane: fit in place, the bucket mask as
            # `active` (no compaction permutation); else the first cap_b lanes
            kernels.count("fit.launched_lanes", min(cap_b, N))
            lanes, posc, infit = _compact(mask, cap_b)
            sel_sig = flat_sig[lanes]
            sel_blocks = blocks_flat[lanes]
            sel_err = error_model(cfg, sel_sig)
            inp = FitInputs(
                y=sel_sig[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
                sigma=sel_err[:, cfg.fit_lo_bin:cfg.fit_hi_bin],
                coeffs=cal["coeffs"][sel_blocks], x0=cal["x0"][sel_blocks],
                t_seed=seed_t_abs[lanes][:, :Pb] - timeref[sel_blocks][:, None],
                a_seed=seed_a[lanes][:, :Pb],
                ped_seed=ped_seed_all[lanes],
                pulse_mask=pulse_mask[lanes][:, :Pb],
                active=mask[lanes],
                timeref=timeref[sel_blocks])
            fres = fit_waveforms(cfg, inp, model_name, plain=plain)
            if fres.rung_lanes is not None:
                rung_lanes.append(fres.rung_lanes)
            pf = torch.cat([fres.params,
                            torch.zeros((fres.params.shape[0], 2 * (P - Pb)),
                                        dtype=dtype, device=dev)], dim=1)
            params = torch.where(infit[:, None], pf[posc], params)
            chi2_ndf = torch.where(infit, fres.chi2_ndf[posc], chi2_ndf)
            converged = converged | (fres.converged[posc] & infit)
            n_iter_lanes = torch.where(infit, fres.n_iter[posc], n_iter_lanes)
            fitted = fitted | infit

    # ---- output-path resolution ------------------------------------------
    with span("engine.resolve"):
        cortime_b = cortime[blocks_flat]
        corr = batch.corr_time_HMS.to(dtype).repeat_interleave(B)   # [N]
        t_param = params[:, 1::2]                       # [N, P] rel bins
        a_param = params[:, 2::2]
        seed_t_rel = seed_t_abs - timeref[blocks_flat][:, None]
        t_rel = torch.where(fitted[:, None], t_param, seed_t_rel)
        a_fin = torch.where((fitted & converged)[:, None], a_param, seed_a)
        pedwf = torch.where(fitted, params[:, 0], ped_seed_all)

        conv_term = (corr - cortime_b - timerefacc * cfg.dt)[:, None]
        t_ns = t_rel * cfg.dt + conv_term               # ref :782-785
        # gate-fail lanes keep raw bin-unit times; slots beyond npulse are zero
        wftime = torch.where(
            pulse_mask, torch.where(fitted[:, None], t_ns, seed_t_abs), 0.0)
        wfampl = torch.where(pulse_mask, a_fin, 0.0)
        chi2 = torch.where(fitted & converged, chi2_ndf, -100.0)

        # timewf/amplwf: |time| closest to zero among valid pulses, first
        # on tie
        abs_t = torch.where(pulse_mask, torch.abs(wftime), float("inf"))
        best = torch.argmin(abs_t, dim=1, keepdim=True)
        has = fitted & (npulse > 0)
        timewf = torch.where(has, torch.gather(wftime, 1, best)[:, 0], -100.0)
        amplwf = torch.where(has, torch.gather(wfampl, 1, best)[:, 0], -100.0)

        # h1/h2 entries (ref :988-997): gate-passed lanes, final amplitude > 20
        h_mask = fitted[:, None] & pulse_mask & (wfampl > cfg.amp_h12_thres)
        h1 = t_rel - timerefacc + corr[:, None] / cfg.dt            # ref :994

    with span("engine.diagnostics"):
        diag = block_diagnostics(cfg, signal)
        enertot, integtot = diag["enertot"], diag["integtot"]
        if block_axis is not None:
            # event totals span every block: the row shards' per-block values,
            # gathered in block order and summed as one device sums them
            enertot, integtot = (
                torch.cat(block_axis.all_gather(diag[k]), dim=-1).sum(dim=-1)
                for k in ("ener_raw", "integ"))
        n_succ = (fitted & converged).sum().to(torch.int32)
        n_fail = (fitted & ~converged).sum().to(torch.int32)
        n_high = (flat_present & (npulse > P - 2)).sum().to(torch.int32)

    out = PipelineOutput(
        wfnpulse=npulse.reshape(E, B),
        wftime=wftime.reshape(E, B, P),
        wfampl=wfampl.reshape(E, B, P),
        pulse_valid=pulse_mask.reshape(E, B, P),
        chi2=chi2.reshape(E, B),
        timewf=timewf.reshape(E, B),
        amplwf=amplwf.reshape(E, B),
        pedwf=pedwf.reshape(E, B),
        gate=front.gate.reshape(E, B),
        fit_converged=(fitted & converged).reshape(E, B),
        fit_n_iter=torch.where(fitted, n_iter_lanes, 0).reshape(E, B),
        h1time=h1.reshape(E, B, P),
        h2time=wftime.reshape(E, B, P),
        h_mask=h_mask.reshape(E, B, P),
        ampl=diag["ampl"], ener=diag["ener"], integ=diag["integ"],
        bkg=diag["bkg"], noise=diag["noise"],
        enertot=enertot, integtot=integtot,
        n_fit_success=n_succ,
        n_fit_failure=n_fail,
        n_fit_dropped=front.n_dropped,
        n_high_pulse=n_high,
        n_search_dropped=front.n_search_dropped,
        search_overflow=front.search_overflow.reshape(E, B))
    return out, (torch.cat(rung_lanes) if rung_lanes else None)


def _fold_tallies(tallies: Optional[torch.Tensor]) -> None:
    """The rung tallies of the fits K3 ran whole, read once the call's work
    is queued (a host sync), into fit.rungs and fit.retry_lanes."""
    if tallies is not None:
        kernels.count("sync.engine.rung_tallies")
        count_rung_lanes(tallies.tolist())


def _eager(cfg: NPSConfig, calib: Dict[str, torch.Tensor], batch: EventBatch,
           block_axis: Optional[Axis], block_shards: int,
           reduce_axes: Tuple[Axis, ...], plain: bool
           ) -> Tuple[PipelineOutput, Tuple[bool, ...]]:
    """The eager body, and which buckets had lanes."""
    cal = _calib_tensors(calib, batch.signal.dtype, batch.signal.device)
    front = _search_and_gate(cfg, cal, batch, block_axis, block_shards, plain)
    E, B = batch.signal.shape[:2]
    filled = _bucket_sizes(cfg, front.sizes, E * B)
    out, tallies = _fit_and_resolve(cfg, cal, batch, front, filled,
                                    block_axis, plain)
    _fold_tallies(tallies)
    if reduce_axes:
        counts = torch.stack([out.n_fit_success, out.n_fit_failure,
                              out.n_fit_dropped, out.n_high_pulse,
                              out.n_search_dropped])
        for ax in reduce_axes:
            counts = ax.all_reduce(counts)
        out = out._replace(**dict(zip(
            ("n_fit_success", "n_fit_failure", "n_fit_dropped",
             "n_high_pulse", "n_search_dropped"), counts.unbind())))
    return out, filled


def process_batch_eager(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                        batch: EventBatch, block_axis: Optional[Axis] = None,
                        block_shards: int = 1,
                        reduce_axes: Tuple[Axis, ...] = (),
                        plain: bool = False) -> PipelineOutput:
    """process_batch's body issued op by op, with process_batch's arguments
    and answer: the search and the gate (``_search_and_gate``), the one
    read of the bucket sizes (``_bucket_sizes``), the fits, the resolution
    and the diagnostics (``_fit_and_resolve``), the read of the rung
    tallies (``_fold_tallies``). Every call off the graph route runs it;
    the graphs capture its two halves."""
    return _eager(cfg, calib, batch, block_axis, block_shards, reduce_axes,
                  plain)[0]


def process_batch(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                  batch: EventBatch, block_axis: Optional[Axis] = None,
                  block_shards: int = 1, reduce_axes: Tuple[Axis, ...] = (),
                  plain: bool = False) -> PipelineOutput:
    """Run the full pipeline on one event batch on one device.

    ``calib`` is ``core.params.calib_to_torch`` of the calibration arrays.
    With ``plain=True`` every kernel's plain PyTorch version runs instead.

    Inside a rank of a mesh (``parallel.mesh``) the batch and the
    calibration are this rank's shard: ``block_axis`` is the block group
    when the rows are split into ``block_shards`` shards (the cluster
    gate's halo exchange; ``enertot``/``integtot`` summed over every block
    of the group, in one device's order), and the five counters are
    summed over every axis of ``reduce_axes``. Capacities act per shard,
    on the local lanes, as in the JAX package.

    Where ``graph_route`` admits the call, its device work runs as two
    CUDA graph replays around the read of the bucket sizes
    (``engine/graphs.py``); every other call runs the eager body,
    ``process_batch_eager``. Both give the same answer and the same
    counts.

    The call is the span ``engine.process_batch``; the eager body's spans
    inside it are ``engine.search`` (with ``search_capacity`` below the
    lane count, ``engine.search.compact`` inside it around the lanes'
    selection and gathers before the search and the gathers back after
    it), ``engine.gate``, one ``engine.bucket`` a pulse-count bucket (its
    fit ladder inside), ``engine.resolve`` and ``engine.diagnostics``, the
    graph route's ``engine.graph.replay`` and ``engine.graph.capture``.
    ``kernels.counts`` takes the call, each host sync by its site (one
    ``sync.engine.bucket_sizes`` a call, one ``sync.engine.rung_tallies``
    where K3 ran a bucket's ladder whole), the lanes handed to the search
    (``engine.search_lanes``), and for each bucket the lanes it fits
    (``fit.stage1_lanes``) and the lanes it hands to ``fit_waveforms``
    (``fit.launched_lanes``: every lane in place); where K3 ran a
    bucket's ladder whole, the lanes its rungs retried (``fit.rungs``,
    ``fit.retry_lanes``) come back in one read at the end.
    """
    if block_axis is not None or block_shards > 1:
        require_axis(block_axis, f"process_batch over {block_shards} block "
                                 f"shard(s): block_axis")
    for ax in reduce_axes:
        require_axis(ax, "each of process_batch's reduce_axes")
    kernels.count("engine.process_batch")
    with span("engine.process_batch"):
        if graph_route(cfg, batch.signal.device, block_axis, reduce_axes,
                       plain):
            from npswf_tpu_torch.engine import graphs
            return graphs.run(cfg, calib, batch)
        return _eager(cfg, calib, batch, block_axis, block_shards,
                      reduce_axes, plain)[0]


# ----------------------------------------------------------------------
# Writer packet: what the WF writer needs, compacted on the device
# ----------------------------------------------------------------------
class WriterPacket(NamedTuple):
    """The minimal device-to-host payload of the WF writer.

    The ragged flatten of the pulse tensors (event -> block -> slot order,
    that of ``writer.flatten_pulses_np``) happens on the device into
    fixed-capacity buffers; ``n_wf``/``n_h`` are the true totals, so the
    executor can fall back to the dense output when they overflow.
    """
    wfnpulse: torch.Tensor       # [E, B] i32
    wf_counts_e: torch.Tensor    # [E] i32 — pulses per event
    wftime_flat: torch.Tensor    # [cap]
    wfampl_flat: torch.Tensor    # [cap]
    n_wf: torch.Tensor           # [] i32 — true total (may exceed cap)
    h_counts_e: torch.Tensor     # [E] i32 — h1/h2 entries per event
    h1time_flat: torch.Tensor    # [cap]
    h2time_flat: torch.Tensor    # [cap]
    n_h: torch.Tensor            # [] i32
    chi2: torch.Tensor           # [E, B]
    ampl: torch.Tensor           # [E, B]
    amplwf: torch.Tensor         # [E, B]
    timewf: torch.Tensor         # [E, B]
    pedwf: torch.Tensor          # [E, B]
    enertot: torch.Tensor        # [E]
    integtot: torch.Tensor       # [E]
    search_overflow: torch.Tensor  # [E, B] bool
    n_fit_success: torch.Tensor
    n_fit_failure: torch.Tensor
    n_fit_dropped: torch.Tensor
    n_high_pulse: torch.Tensor
    n_search_dropped: torch.Tensor


def _ragged_flatten_device(mask: torch.Tensor, arrays, cap: int):
    """Compact ``arrays[mask]`` (row-major) into [cap] buffers + true count.

    A stable argsort keyed on ``~mask`` front-packs the masked elements in
    their row-major order, then one gather per array; masked-out values
    are zeroed first, so the buffers end in zeros up to ``cap`` (the JAX
    package's stable multi-operand sort, element for element). No host
    sync."""
    v = mask.reshape(-1)
    order = torch.argsort((~v).to(torch.int32), stable=True)[:cap]
    flats = tuple(torch.where(v, a.reshape(-1), torch.zeros((), dtype=a.dtype,
                                                            device=a.device))[order]
                  for a in arrays)
    return flats, v.sum(dtype=torch.int32)


def pack_for_writer(out: PipelineOutput, cap: int) -> WriterPacket:
    E, B, P = out.wftime.shape
    prefix = (torch.arange(P, dtype=torch.int32, device=out.wftime.device)
              [None, None, :] < out.wfnpulse[:, :, None])
    (wt, wa), n_wf = _ragged_flatten_device(
        prefix, (out.wftime, out.wfampl), cap)
    (h1f, h2f), n_h = _ragged_flatten_device(
        out.h_mask, (out.h1time, out.h2time), cap)
    return WriterPacket(
        wfnpulse=out.wfnpulse,
        wf_counts_e=out.wfnpulse.sum(dim=1, dtype=torch.int32),
        wftime_flat=wt, wfampl_flat=wa, n_wf=n_wf,
        h_counts_e=out.h_mask.sum(dim=(1, 2), dtype=torch.int32),
        h1time_flat=h1f, h2time_flat=h2f, n_h=n_h,
        chi2=out.chi2, ampl=out.ampl, amplwf=out.amplwf,
        timewf=out.timewf, pedwf=out.pedwf,
        enertot=out.enertot, integtot=out.integtot,
        search_overflow=out.search_overflow,
        n_fit_success=out.n_fit_success, n_fit_failure=out.n_fit_failure,
        n_fit_dropped=out.n_fit_dropped, n_high_pulse=out.n_high_pulse,
        n_search_dropped=out.n_search_dropped)


# ----------------------------------------------------------------------
# One fp32 buffer a batch: the packet serialized on the device
# ----------------------------------------------------------------------
# Every field is exact in fp32: pulse counts <= 12, flat counts < 2^24,
# flags, and the outputs themselves, which the writer stores from fp32
# whatever the compute dtype (as the JAX package does), so one
# device-to-host copy carries the whole packet.

# the per-lane [E, B] packet fields, in order (subject to lane compaction)
_LANE_FIELDS = ("wfnpulse", "chi2", "ampl", "amplwf", "timewf", "pedwf",
                "search_overflow")


def _packet_layout(E: int, B: int, cap: int):
    """[(field, shape, host dtype)] in dense serialization order (None:
    float32); the sparse layout is ``_slab_layout``."""
    i32, f32, bl = np.int32, None, bool
    lane_shape = (E, B)
    return [
        ("wfnpulse", lane_shape, i32), ("wf_counts_e", (E,), i32),
        ("wftime_flat", (cap,), f32), ("wfampl_flat", (cap,), f32),
        ("n_wf", (), i32), ("h_counts_e", (E,), i32),
        ("h1time_flat", (cap,), f32), ("h2time_flat", (cap,), f32),
        ("n_h", (), i32), ("chi2", lane_shape, f32),
        ("ampl", lane_shape, f32),
        ("amplwf", lane_shape, f32), ("timewf", lane_shape, f32),
        ("pedwf", lane_shape, f32), ("enertot", (E,), f32),
        ("integtot", (E,), f32), ("search_overflow", lane_shape, bl),
        ("n_fit_success", (), i32), ("n_fit_failure", (), i32),
        ("n_fit_dropped", (), i32), ("n_high_pulse", (), i32),
        ("n_search_dropped", (), i32),
    ]


def flatten_packet(pkt: WriterPacket) -> torch.Tensor:
    """Serialize (on the device) to one [total] fp32 vector."""
    return torch.cat([getattr(pkt, name).reshape(-1).to(torch.float32)
                      for name, _, _ in _packet_layout(
                          *pkt.wfnpulse.shape, pkt.wftime_flat.shape[0])])


# ---- slab packet (sparse readout) ------------------------------------
# With few present lanes the packet ships per-lane slabs ([lane_cap, P]
# rows in row-major present order: one [E*B] argsort and gathers) instead
# of flattening on the device; the host rebuilds the exact ragged arrays.
# Only lane overflow (more present lanes than lane_cap) forces the dense
# fallback.

def _slab_layout(E: int, B: int, P: int, lane_cap: int):
    """[(field, shape, host dtype)] for the slab packet serialization."""
    i32, f32, bl = np.int32, None, bool
    lane_dt = {"wfnpulse": i32, "search_overflow": bl}
    layout = [
        ("wfnpulse", (lane_cap,), i32), ("wf_counts_e", (E,), i32),
        ("wftime_slab", (lane_cap, P), f32),
        ("wfampl_slab", (lane_cap, P), f32),
        ("h1_slab", (lane_cap, P), f32),
        ("h2_slab", (lane_cap, P), f32),
        ("hmask_slab", (lane_cap, P), bl),
        ("h_counts_e", (E,), i32),
        ("chi2", (lane_cap,), f32), ("ampl", (lane_cap,), f32),
        ("amplwf", (lane_cap,), f32), ("timewf", (lane_cap,), f32),
        ("pedwf", (lane_cap,), f32),
        ("enertot", (E,), f32), ("integtot", (E,), f32),
        ("search_overflow", (lane_cap,), bl),
        ("n_fit_success", (), i32), ("n_fit_failure", (), i32),
        ("n_fit_dropped", (), i32), ("n_high_pulse", (), i32),
        ("n_search_dropped", (), i32),
    ]
    layout += [(f"default_{f}", (), lane_dt.get(f)) for f in _LANE_FIELDS]
    layout.append(("n_pres", (), i32))
    return layout


def flatten_packet_slab(out: PipelineOutput, pres: torch.Tensor,
                        lane_cap: int) -> torch.Tensor:
    """Serialize a PipelineOutput directly to one [total] fp32 slab packet.

    ``pres`` is the decoder's present mask (EventBatch.pres as uploaded).
    No ragged flatten happens on the device; see _slab_layout."""
    E, B, P = out.wftime.shape
    v = pres.reshape(-1).to(torch.int32)
    sel = torch.argsort(1 - v, stable=True)[:lane_cap]   # present lanes first
    idx_abs = torch.argmin(v)                            # first absent lane
    lane2d = {"wftime_slab": out.wftime, "wfampl_slab": out.wfampl,
              "h1_slab": out.h1time, "h2_slab": out.h2time,
              "hmask_slab": out.h_mask}
    derived = {
        "wf_counts_e": out.wfnpulse.sum(dim=1, dtype=torch.int32),
        "h_counts_e": out.h_mask.sum(dim=(1, 2), dtype=torch.int32),
        "n_pres": v.sum(dtype=torch.int32),
    }
    parts = []
    for name, _, _ in _slab_layout(E, B, P, lane_cap):
        if name in lane2d:
            val = lane2d[name].reshape(E * B, P)[sel]
        elif name in derived:
            val = derived[name]
        elif name.startswith("default_"):
            val = getattr(out, name[len("default_"):]).reshape(-1)[idx_abs]
        elif name in _LANE_FIELDS:
            val = getattr(out, name).reshape(-1)[sel]
        else:
            val = getattr(out, name)
        parts.append(val.reshape(-1).to(torch.float32))
    return torch.cat(parts)


def unflatten_packet_slab(buf, E: int, B: int, P: int, lane_cap: int,
                          pres) -> Tuple[WriterPacket, bool]:
    """Host-side inverse of ``flatten_packet_slab``: rebuilds the exact
    WriterPacket (including the ragged wftime/wfampl/h1/h2 flats the
    writer consumes, in the same row-major element order the device
    flatten produced). Returns (packet, lane_overflow)."""
    import numpy as np
    buf = np.asarray(buf)
    fields = {}
    off = 0
    for name, shape, dt in _slab_layout(E, B, P, lane_cap):
        n = 1
        for s in shape:
            n *= s
        val = buf[off:off + n].reshape(shape)
        if dt is not None:
            val = val.astype(dt if dt is bool else np.int32)
        fields[name] = val if shape else val[()]
        off += n
    n_pres = int(fields.pop("n_pres"))
    rows = np.flatnonzero(np.asarray(pres).astype(bool).reshape(-1))
    overflow = n_pres > lane_cap
    nr = min(rows.size, lane_cap)

    def dense_lane(f):
        default = fields.pop(f"default_{f}")
        vals = np.asarray(fields.pop(f))
        dense = np.full(E * B, default, vals.dtype)
        if not overflow:
            dense[rows] = vals[:nr]
        return dense

    wfnpulse = dense_lane("wfnpulse")
    lane_fields = {f: dense_lane(f).reshape(E, B)
                   for f in _LANE_FIELDS if f != "wfnpulse"}

    def dense_slab(name, dtype):
        slab = fields.pop(name)
        dense = np.zeros((E * B, P), dtype)
        if not overflow:
            dense[rows] = slab[:nr].astype(dtype)
        return dense

    wt = dense_slab("wftime_slab", np.float32)
    wa = dense_slab("wfampl_slab", np.float32)
    h1 = dense_slab("h1_slab", np.float32)
    h2 = dense_slab("h2_slab", np.float32)
    hm = dense_slab("hmask_slab", bool)
    prefix = np.arange(P)[None, :] < wfnpulse[:, None]
    pkt = WriterPacket(
        wfnpulse=wfnpulse.reshape(E, B),
        wf_counts_e=fields["wf_counts_e"],
        wftime_flat=wt[prefix], wfampl_flat=wa[prefix],
        n_wf=int(prefix.sum()),
        h_counts_e=fields["h_counts_e"],
        h1time_flat=h1[hm], h2time_flat=h2[hm], n_h=int(hm.sum()),
        chi2=lane_fields["chi2"], ampl=lane_fields["ampl"],
        amplwf=lane_fields["amplwf"], timewf=lane_fields["timewf"],
        pedwf=lane_fields["pedwf"],
        enertot=fields["enertot"], integtot=fields["integtot"],
        search_overflow=lane_fields["search_overflow"],
        n_fit_success=fields["n_fit_success"],
        n_fit_failure=fields["n_fit_failure"],
        n_fit_dropped=fields["n_fit_dropped"],
        n_high_pulse=fields["n_high_pulse"],
        n_search_dropped=fields["n_search_dropped"])
    return pkt, overflow


def unflatten_packet(buf, E: int, B: int, cap: int,
                     pres=None, lane_cap: int = 0, P: int = 0):
    """Host-side inverse of the packet serializations (numpy in/out).

    ``lane_cap`` == 0: inverse of ``flatten_packet`` (dense mode).
    ``lane_cap`` > 0: inverse of ``flatten_packet_slab`` — the caller
    passes the decoded ``pres`` [E, B] host mask and ``P``
    (cfg.maxwfpulses); the ragged flats are rebuilt host-side.

    Returns ``(packet, lane_overflow)``: ``lane_overflow`` is True when
    the batch had more present lanes than ``lane_cap`` (the packet is
    then unusable — the executor falls back to the dense fetch of the
    full PipelineOutput)."""
    if lane_cap > 0:
        return unflatten_packet_slab(buf, E, B, P, lane_cap, pres)
    import numpy as np
    buf = np.asarray(buf)
    fields = {}
    off = 0
    for name, shape, dt in _packet_layout(E, B, cap):
        n = 1
        for s in shape:
            n *= s
        v = buf[off:off + n].reshape(shape)
        if dt is not None:
            v = v.astype(dt if dt is bool else np.int32)
        fields[name] = v if shape else v[()]
        off += n
    return WriterPacket(**fields), False


def _packed(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
            batch: EventBatch, cap: int, lane_cap: int) -> torch.Tensor:
    out = process_batch(cfg, calib, batch)
    if lane_cap > 0:
        return flatten_packet_slab(out, batch.pres, lane_cap)
    return flatten_packet(pack_for_writer(out, cap))


def make_pipeline_packed(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                         cap: int, lane_cap: int = 0):
    """``fn(batch) -> [total] fp32``: process_batch, the writer packing and
    its serialization, one buffer a batch on the batch's device. With
    ``lane_cap`` > 0 the slab packet (present lanes only)."""
    return functools.partial(_packed, cfg, calib, cap=cap, lane_cap=lane_cap)


# ----------------------------------------------------------------------
# Chains: k batches a call, one stacked result
# ----------------------------------------------------------------------
# The JAX package scans k batches inside one executable; here the k
# process_batch calls run in turn and their packets are stacked, so the
# caller fetches one [k, total] buffer with one copy. Lane results never
# depend on batch neighbours: a chain equals k single calls bit for bit.

def make_pipeline_packed_chain(cfg: NPSConfig, calib: Dict[str, torch.Tensor],
                               cap: int, lane_cap: int = 0):
    """Chained make_pipeline_packed: ``fn(batches) -> [k, total]`` fp32,
    the packets of k EventBatches stacked."""
    packed = make_pipeline_packed(cfg, calib, cap, lane_cap)

    def chain(batches) -> torch.Tensor:
        return torch.stack([packed(b) for b in batches])
    return chain
