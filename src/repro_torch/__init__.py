"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

The package mirrors ``repro``'s layout (``core/``, ``kernels/``,
``models/``, ``serve/``, ``launch/``) so each module's counterpart sits
at the same path.  It imports ``torch``, numpy and the standard library
only — never ``jax`` and nothing of ``repro``.  Entry points take a
``device`` that defaults to ``"cuda"`` and raise when no card is present
(see ``repro_torch.device``); the tests pass ``device="cpu"``.
"""
