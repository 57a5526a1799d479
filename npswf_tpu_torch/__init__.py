"""npswf_tpu_torch — the NPS waveform analysis ported to PyTorch and CUDA.

The JAX package ``npswf_tpu`` beside this one is the reference; this package
mirrors its layout and names so each counterpart is easy to find:

- ``core.params``  — calibration arrays and event batches to tensors
- ``ops``          — matched filter, TSpectrum-parity peak search, 3x3
                     cluster gate, cubic-spline evaluation
- ``models``       — the spline reference waveform model
- ``fit``          — error model, Cholesky, the bounded LM fit with its
                     stage-2/stage-3 retry ladder
- ``engine``       — ``process_batch`` (one event batch, single device) and
                     the block diagnostics
- ``kernels``      — builds the CUDA library from ``csrc/`` with nvcc and
                     keeps the launch counters
- ``csrc``         — the hand-written Hopper kernels: matched filter
                     (``matched_filter.cu``), peak-search operands
                     (``search.cu``) and the whole-loop LM stage (``lm.cu``)

It imports torch and numpy, plus the jax-free host layer of the reference
(``npswf_tpu.core``, ``npswf_tpu.utils.synthetic``, ``npswf_tpu.golden``),
and never jax.

Dispatch: each kernel has a wrapper and a plain PyTorch version in the same
package. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises. Passing ``plain=True`` to the
public functions runs the plain versions on any device (the reference the
kernels are held against on the card).

``NPSConfig`` knobs that change results are honoured. These layout-only
knobs are ignored, since they change no result: ``use_pallas``,
``use_pallas_lm``, ``use_pallas_search``, ``use_fused_system``,
``use_fused_neq``, ``interpret_pallas``, ``pallas_search_tile``,
``pallas_lm_tile``, ``spline_mode``, ``fit_chunk``, ``lm_unroll``,
``lm_stage1_tier``, ``lm_stage2_mode`` and ``pallas_search_select``.
"""

__version__ = "0.1.0"
