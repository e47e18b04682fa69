"""Serving engines of the port: the continuous-batching scheduler, the
paged KV pool, the cloud-only engine and the collaborative engine."""
