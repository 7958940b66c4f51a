"""Speculative decoding with a vanilla draft model (port of
mlx_vlm_tpu/speculative/__init__.py; `batch.py` holds the serving
generator)."""

from .utils import load_drafter, run_speculative_rounds, speculative_generate_step

__all__ = ["run_speculative_rounds", "speculative_generate_step", "load_drafter"]
