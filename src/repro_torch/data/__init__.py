# The training path's deterministic synthetic data (numpy, as the
# reference's), moved to the training device per step.
