# Hand-written CUDA kernels for Hopper (sources in ../csrc), each with its
# plain PyTorch version beside its wrapper: merge (compaction and ingest),
# bloom (per-SSTable filter build and probe), lookup (the fused read
# path over a device-resident tier or store view) and attention (the
# flash-attention forward of the serving path).
