"""Conversions into the port (state carried across from the JAX package)."""

from torchmetrics_tpu_torch.convert.jax_state import jax_state_to_torch, load_jax_state

__all__ = ["jax_state_to_torch", "load_jax_state"]
