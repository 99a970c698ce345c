"""Multi-process runs of the port: ``distributed`` (the process group and
data parallelism), ``mesh``, ``tp`` (tensor parallelism) and ``fsdp``."""
