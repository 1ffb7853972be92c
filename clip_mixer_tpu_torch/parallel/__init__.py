"""The parallel layer of the port: the process group, the data-parallel mesh and the train step
(FSDP in ``fsdp.py``, tensor parallelism in ``tp.py``; pipeline stages wait for ROADMAP.md item 16b)."""
