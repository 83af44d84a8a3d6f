# Hand-written CUDA kernels for Hopper (sources in ../csrc), each with its
# plain PyTorch version beside its wrapper: merge (compaction and ingest),
# bloom (per-SSTable filter build and probe) and lookup (the fused read
# path over a device-resident tier or store view).
