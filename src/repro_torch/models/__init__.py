"""LM layers and the decoder-only transformer of the port."""
