"""npswf_tpu_torch — the NPS waveform analysis ported to PyTorch and CUDA.

The JAX package ``npswf_tpu`` beside this one is the reference; this package
mirrors its layout and names so each counterpart is easy to find:

- ``core.config``, ``core.calibration`` — copies of the reference's
                     host layer (``NPSConfig``, the calibration bundle)
- ``core.params``  — calibration arrays and event batches to tensors
- ``utils.synthetic`` — a copy of the reference's synthetic events
- ``ops``          — matched filter, TSpectrum-parity peak search, 3x3
                     cluster gate, cubic-spline evaluation
- ``models``       — the spline reference waveform model
- ``fit``          — error model, Cholesky, the bounded LM fit with its
                     stage-2/stage-3 retry ladder, and the system
                     evaluations of its generic loop (``eval_kernel``)
- ``engine``       — ``process_batch`` (one event batch, single device),
                     the block diagnostics, the writer packets (dense and
                     slab) and the chains of batches
- ``io``           — copies of the reference's host I/O: raw segments,
                     their decode (``io/native/decode.cpp``, built with g++
                     into ``build/npswf_tpu_torch/``; numpy on request), the
                     WF writer and the streaming merge of its parts
- ``golden``       — the raw-stream decode oracle (a copy)
- ``runtime``      — ``executor.run_segment``: a raw segment to a WF file,
                     two stage workers with a CUDA stream each, ordered
                     fetch, a writer thread, resume
- ``tools``        — ``cli`` (``python -m npswf_tpu_torch.tools.cli
                     run|synth|validate``) and ``plotstats`` (a copy)
- ``utils.timers`` — stage timers (a copy) and a ``torch.profiler`` trace
- ``kernels``      — builds the CUDA library from ``csrc/`` with nvcc and
                     keeps the launch counters
- ``csrc``         — the hand-written Hopper kernels: matched filter
                     (``matched_filter.cu``), peak search up to its sort
                     operands or its top-P slots (``search.cu``), the
                     whole-loop LM stage (``lm.cuh``; ``lm.cu`` dispatches
                     to its widths, compiled in groups in ``lm_p*.cu``) and
                     the generic loop's system evaluations (``eval.cu``)

It imports torch and numpy, never jax and nothing of ``npswf_tpu``: the
host layer it needs is copied, and ``tests/test_torch_host.py`` pins each
copy to its original.

Dispatch: each kernel has a wrapper and a plain PyTorch version in the same
package. A wrapper given CPU tensors runs the plain version; given CUDA
tensors it launches its kernel or raises. Passing ``plain=True`` to the
public functions runs the plain versions on any device (the reference the
kernels are held against on the card). The entry points (``run_segment``,
the CLI's ``run``) use the CUDA device unless the caller asks for the CPU
(``device="cpu"``, ``--cpu``); without a card they raise.

``NPSConfig`` knobs that change results are honoured, and so are the four
that route work onto kernels as the reference does: ``use_pallas_lm`` with
``pallas_lm_max_pulses`` (the whole-loop LM kernel), ``use_fused_neq`` and
``use_fused_system`` (the generic loop's system evaluation) and
``pallas_search_select`` (the in-kernel top-P search). These layout-only
knobs are ignored, since they change no result: ``use_pallas``,
``use_pallas_search``, ``interpret_pallas``, ``pallas_search_tile``,
``pallas_lm_tile``, ``spline_mode``, ``fit_chunk``, ``lm_unroll``,
``lm_stage1_tier`` and ``lm_stage2_mode``; so is the CLI's ``--x64`` (the
compute dtype is ``compute_dtype``).
"""

__version__ = "0.1.0"
