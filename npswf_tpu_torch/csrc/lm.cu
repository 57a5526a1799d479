// K3's entry points: the width dispatch and the C interface (the kernel is
// in lm.cuh, its instantiations in lm_p*.cu, the wider widths in
// lm_wide.cu, which also holds npswf_lm_max_pulses).
#include "lm.cuh"

NPSWF_LM_WIDTH(extern, 1)
NPSWF_LM_WIDTH(extern, 2)
NPSWF_LM_WIDTH(extern, 3)
NPSWF_LM_WIDTH(extern, 4)
NPSWF_LM_WIDTH(extern, 5)
NPSWF_LM_WIDTH(extern, 6)
NPSWF_LM_WIDTH(extern, 7)
NPSWF_LM_WIDTH(extern, 8)
NPSWF_LM_WIDTH(extern, 9)
NPSWF_LM_WIDTH(extern, 10)
NPSWF_LM_WIDTH(extern, 11)
NPSWF_LM_WIDTH(extern, 12)
NPSWF_LM_WIDTH(extern, 13)
NPSWF_LM_WIDTH(extern, 14)
NPSWF_LM_WIDTH(extern, 15)

namespace npswf {

// the widths above kMaxP, P at run time (lm_wide.cu)
template <typename T>
cudaError_t launch_wide(int p, const void* const* in, void* const* out,
                        const LMParams& prm, cudaStream_t st);

template <typename T, int P>
static cudaError_t dispatch_from(int p, const void* const* in, void* const* out,
                                 const LMParams& prm, cudaStream_t st) {
  if constexpr (P > kMaxP) {
    return launch_wide<T>(p, in, out, prm, st);
  } else {
    if (p == P) return launch<T, P>(in, out, prm, st);
    return dispatch_from<T, P + 1>(p, in, out, prm, st);
  }
}

}  // namespace npswf

// in: coeffs, x0, yt, wt, u0, lo, hi, pseed, pmask, active, budget, lam0,
// budget2, pullback; out: u, chi2, conv, n_iter, edm, lam, u2, chi2_2,
// conv2, it2, tally. rungs = 0 runs one stage (budget2, pullback and the
// last five outputs may be null); rungs > 0 runs the fit's ladder in the
// same launch (lm.cuh): the stage-2 restart (lam2, budget2, max_iter2) and
// rungs - 1 pull-backs (pullback[0..rungs-2], fp64 on the device, lam3),
// at the compiled widths only.
extern "C" int npswf_lm_solve(int dtype, int p, const void* const* in,
                              void* const* out, int n, int nk, int fit_lo,
                              int max_iter, int max_iter2, int rungs,
                              double lam_up, double lam_down, double lam_min,
                              double lam_max, double ftol, double gtol,
                              double eps, double gate_lo, double gate_hi,
                              double sat, double chol_eps, double lam2,
                              double lam3, void* stream) {
  if (rungs < 0 || (rungs > 0 && p > npswf::kMaxP))
    return (int)cudaErrorInvalidValue;
  npswf::LMParams prm;
  prm.lam_up = lam_up;
  prm.lam_down = lam_down;
  prm.lam_min = lam_min;
  prm.lam_max = lam_max;
  prm.ftol = ftol;
  prm.gtol = gtol;
  prm.eps = eps;
  prm.gate_lo = gate_lo;
  prm.gate_hi = gate_hi;
  prm.sat = sat;
  prm.chol_eps = chol_eps;
  prm.lam2 = lam2;
  prm.lam3 = lam3;
  prm.fit_lo = fit_lo;
  prm.nk = nk;
  prm.n = n;
  prm.max_iter = max_iter;
  prm.max_iter2 = max_iter2;
  prm.rungs = rungs;
  cudaStream_t st = (cudaStream_t)stream;
  return (int)(dtype == npswf::kFloat32
                   ? npswf::dispatch_from<float, 1>(p, in, out, prm, st)
                   : npswf::dispatch_from<double, 1>(p, in, out, prm, st));
}
