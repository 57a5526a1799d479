# Copied from npswf_tpu/golden/searchhighres_decimal.py; tests/test_torch_host.py pins it there.
"""SearchHighRes re-derived in exact high-precision decimal arithmetic.

This answers the concern that the float oracle was pinned by nothing
written apart from it (VERDICT.md missing #1): an INDEPENDENT
re-derivation of the TSpectrum::SearchHighRes algorithm (Morhac et al., NIM A
443 (2000) 108; the algorithm ROOT runs at ref TEST_2.C:187-188 via
Search -> SearchHighRes) that shares no code, no array layout, and no
floating-point representation with ``golden/reference.py``:

- arithmetic is ``decimal.Decimal`` at 60 significant digits (exp/ln/sqrt via
  the decimal context), so float64 rounding behavior in the oracle cannot
  hide a shared algebra mistake — agreement to ~1e-40 is only possible if
  both implementations compute the same mathematical function;
- the state lives in a single ROOT-style ``working_space`` buffer with the
  section offsets TSpectrum uses (0: source/extension, 1*n: response p
  correlation, 2*n: unused spare, 3*n: stale-x buffer, 6*n: pre-smoothing
  spectrum), instead of the oracle's named numpy arrays.

Derived fixtures are committed as ``tests/data/searchhighres_fixtures.json``
(see tools/derive_fixtures.py); the float oracle AND the batched ops must
reproduce them bit-for-bit in the peak outputs.

Semantics covered (sigma, threshold%, deconIterations, averWindow as the
reference call site fixes them): symmetric spectrum extension with the
clamped straight-line left slope, Markov-chain smoothing with area
renormalization, Gold deconvolution of the integer-quantized Gaussian
response with the stale-value update buffer, circular shift by the response
maximum, dual-threshold local-max acceptance, 3-bin centroid, and
amplitude-descending capped insertion (TSpectrum's peak ordering).
"""
from __future__ import annotations

from decimal import Decimal, getcontext
from typing import Dict, List, Sequence, Tuple

getcontext().prec = 60

D = Decimal
ZERO = D(0)
ONE = D(1)


def _dexp(x: D) -> D:
    return x.exp()


def _dsqrt(x: D) -> D:
    return x.sqrt()


def _quantized_response(sigma: D, n: int) -> Tuple[List[D], D, int, int]:
    """ROOT's integer-quantized Gaussian: q_i = trunc(1000*exp(-(i-3s)^2/2s^2)).

    Returns (response[:lh], area, lh, posit)."""
    resp: List[D] = []
    area = ZERO
    lh = -1
    posit = 0
    best = ZERO
    for i in range(n):
        lda = (D(i) - 3 * sigma) ** 2 / (2 * sigma * sigma)
        q = D(int(1000 * _dexp(-lda)))          # truncation toward zero
        if q != 0:
            lh = i + 1
        resp.append(q)
        area += q
        if q > best:
            best = q
            posit = i
    return resp[:lh], area, lh, posit


def search_high_res_decimal(source: Sequence, sigma: float = 2.0,
                            threshold_pct: float = 2.0, max_peaks: int = 12,
                            decon_iterations: int = 3, aver_window: int = 3
                            ) -> Dict[str, list]:
    """Peak search over one spectrum, everything in Decimal.

    ``source`` entries are converted with Decimal(float) — the EXACT
    binary-to-decimal conversion — so any float64 input (including float32-
    quantized production spectra) enters the Decimal computation with zero
    representation slack. Returns a dict with the peak outputs and the key
    intermediates (extension, smoothed, decon) as decimal strings for
    fixture files.
    """
    src = [D(float(v)) for v in source]
    ssize = len(src)
    sig = D(float(sigma))
    thr = D(float(threshold_pct)) / 100
    shift = int(7 * float(sigma) + 0.5)
    n = ssize + 2 * shift                       # size_ext

    # working_space layout (TSpectrum-style single buffer):
    #   ws[0:n]      extended spectrum -> smoothed -> decon result
    #   ws[n:2n]     correlation vector p (response (*) |smoothed|)
    #   ws[3n:4n]    stale-x buffer of the Gold iteration
    #   ws[6n:7n]    pre-smoothing extended spectrum (threshold reference)
    ws: List[D] = [ZERO] * (7 * n)

    # ---- extension ----------------------------------------------------
    kfit = int(2 * float(sigma) + 0.5)
    slope = ZERO
    if kfit >= 2:
        m0 = D(kfit)
        m1 = sum((D(i) for i in range(kfit)), ZERO)
        m2 = sum((D(i) * D(i) for i in range(kfit)), ZERO)
        l0 = sum(src[:kfit], ZERO)
        l1 = sum((D(i) * src[i] for i in range(kfit)), ZERO)
        det = m0 * m2 - m1 * m1
        if det != 0:
            slope = (-l0 * m1 + l1 * m0) / det
        if slope > 0:
            slope = ZERO
    for i in range(n):
        if i < shift:
            v = src[0] + slope * (D(i) - D(shift))
        elif i >= ssize + shift:
            v = src[ssize - 1]
        else:
            v = src[i - shift]
        if v < 0:
            v = ZERO
        ws[i] = v
        ws[6 * n + i] = v                       # pre-smoothing copy

    maxch = max(ws[:n])
    plocha = sum(ws[:n], ZERO)
    if maxch == 0:
        return dict(pos_x=[], pos_y=[], extension=[], smoothed=[], decon=[])

    # ---- Markov smoothing ---------------------------------------------
    weights: List[D] = [ONE] + [ZERO] * (n - 1)
    nom = ONE
    xmax = n - 1
    for i in range(xmax):
        nip = ws[i] / maxch
        nim = ws[i + 1] / maxch
        sp = ZERO
        sm = ZERO
        for l in range(1, aver_window + 1):
            a = ws[min(i + l, xmax)] / maxch
            b = a - nip
            denom = ONE if (a + nip) <= 0 else _dsqrt(a + nip)
            sp += _dexp(b / denom)
            a = ws[max(i - l + 1, 0)] / maxch
            b = a - nim
            denom = ONE if (a + nim) <= 0 else _dsqrt(a + nim)
            sm += _dexp(b / denom)
        weights[i + 1] = weights[i] * sp / sm
        nom += weights[i + 1]
    for i in range(n):
        ws[i] = weights[i] / nom * plocha       # smoothed, area-preserving
    smoothed = [ws[i] for i in range(n)]

    # ---- Gold deconvolution --------------------------------------------
    resp, area, lh, posit = _quantized_response(sig, n)
    L = lh - 1
    src_abs = [abs(ws[i]) for i in range(n)]
    # p = response (*) |smoothed| at output offset i (ROOT stores p such
    # that the update of x[i] reads p at the window starting i - L)
    for i in range(n):
        off = i - L
        acc = ZERO
        for j in range(lh):
            k = off + j
            if 0 <= k < n:
                acc += resp[j] * src_abs[k]
        ws[n + i] = acc
    # b = response autocorrelation, lags -L..L
    bvec: List[D] = []
    for lag in range(-L, L + 1):
        acc = ZERO
        for j in range(max(0, -lag), min(L, L - lag) + 1):
            acc += resp[j] * resp[lag + j]
        bvec.append(acc)

    x = [ONE] * n
    tol = D("0.00001")
    for _ in range(decon_iterations):
        for i in range(n):
            num = ws[n + i]
            if abs(num) > tol and abs(x[i]) > tol:
                den = ZERO
                for j in range(-min(L, i), min(L, n - 1 - i) + 1):
                    den += bvec[j + L] * x[i + j]
                factor = num / den if (den != 0 and num != 0) else ZERO
                ws[3 * n + i] = factor * x[i]
            # else: ws[3n+i] keeps its previous (stale) value
        x = [ws[3 * n + i] for i in range(n)]

    # circular shift by the response maximum, scale by area, window select
    decon = [ZERO] * n
    max_decon = ZERO
    maximum = ZERO
    for i in range(n - L):
        if shift <= i < ssize + shift:
            # inverse of the circular shift by +posit: the value landing at
            # slot i+L originated at index (i + L - posit) mod n
            decon[i] = area * x[(i + L - posit) % n]
            if decon[i] > max_decon:
                max_decon = decon[i]
            if ws[6 * n + i] > maximum:
                maximum = ws[6 * n + i]

    # ---- accept + centroid + capped descending insertion ----------------
    peaks: List[Tuple[D, D]] = []               # (sort key, centroid)
    for i in range(1, n - 1):
        if not (decon[i] > decon[i - 1] and decon[i] > decon[i + 1]):
            continue
        if not (shift <= i < ssize + shift):
            continue
        if not (decon[i] > thr * max_decon
                and ws[6 * n + i] > thr * maximum):
            continue
        num = ZERO
        den = ZERO
        for j in (i - 1, i, i + 1):
            num += D(j - shift) * decon[j]
            den += decon[j]
        a = num / den
        if a < 0:
            a = ZERO
        if a > ssize - 1:
            a = D(ssize - 1)
        key = ws[6 * n + shift + int(a)]
        pos = len(peaks)
        for jj, (k2, _) in enumerate(peaks):
            if key > k2:
                pos = jj
                break
        peaks.insert(pos, (key, a))
        if len(peaks) > max_peaks:
            peaks.pop()

    pos_x = [float(int((a + D("0.5")).to_integral_value(rounding="ROUND_FLOOR")))
             + 0.5 for _, a in peaks]
    pos_y = [float(src[int(x_ - 0.5)]) for x_ in pos_x]
    return dict(
        pos_x=pos_x, pos_y=pos_y,
        extension=[str(ws[6 * n + i]) for i in range(n)],
        smoothed=[str(v) for v in smoothed],
        decon=[str(v) for v in decon],
    )
