"""The parallel layer of the port: the process group, the data-parallel mesh and the train step
(FSDP, tensor parallelism and pipeline stages wait for ROADMAP.md item 16)."""
