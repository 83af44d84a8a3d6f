# Hand-written CUDA kernels for Hopper (sources in ../csrc), each with its
# plain PyTorch version beside its wrapper: merge (compaction and ingest)
# and bloom (per-SSTable filter build and probe).
