# Analytical model-FLOP counts (MFU's numerator).
