"""Device-side building blocks of the port: weights, stats, propagation,
the carry-mode WGS step (plain PyTorch and CUDA) and the GS engine."""
