"""Training: AdamW and 8-bit AdamW (``optim``), quantization-aware
training (``qat``), INT8 gradient compression with error feedback
(``grad_compress``), gradient routing into accumulation buffers
(``grads``) and the ``Trainer`` loop (``loop``)."""
