"""The benchmark's plain reference: f32 PyTorch (TF32 off on a card) of the
denoisers, the DDIM step, the training objective and AdamW + EMA. It
imports nothing of the program (``dsdiff_torch``) and nothing of JAX."""
