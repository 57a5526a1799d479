"""The plain reference that decides ``correct``: a frozen copy of the port's
plain path (``process_batch(..., plain=True)`` on the default route) in
``pipeline.py``, and of its host decode in ``segment.py``. It imports
nothing of the port and nothing of JAX, and takes the benchmark's generated
calibration and events, never the program's derived tensors."""
