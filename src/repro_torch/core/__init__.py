"""Quantization core, layer graph, partitioning, cost model and
Algorithm 1 (the auto-tuner) of the PyTorch port."""
