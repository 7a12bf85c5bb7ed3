"""Diffusive-wave mainstem solver (port of ``troute_tpu/diffusive``)."""
