"""Operations helpers of the port: the per-card memory plan (``memory.py``) and profiling (``profiling.py``)."""
