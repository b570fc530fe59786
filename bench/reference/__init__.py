"""The plain reference: f32 PyTorch, imports neither ``jax`` nor ``repro``
nor anything of ``repro_torch``, and takes only what the benchmark made
(tokens, weights) or the program's stored state that it judges."""
