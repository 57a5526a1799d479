"""The benchmark of ``npswf_tpu_torch``, the PyTorch/CUDA port, on one card.

``wfbench/run.py`` runs one cell of ``BENCHMARK.json``. Everything that
measures lives here and is frozen against later changes of the program:
the traffic generators (``generate.py``), the plain reference
(``reference/``), the comparison that decides ``correct``
(``compare.py``), the profile reduction (``profile.py``), the roofline
counts (``roofline.py``). A configuration, a traffic mix, a per-layer
metric and a cell's limits are data files found by name (``spec.py``).
Nothing here imports ``jax``, ``jaxlib`` or the JAX package ``npswf_tpu``.
"""
