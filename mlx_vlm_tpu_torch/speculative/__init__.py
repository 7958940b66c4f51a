"""Speculative decoding (port of mlx_vlm_tpu/speculative/__init__.py):
the vanilla drafter (`utils.py`; `batch.py` holds the serving generator)
and the target-coupled drafters (`drafters/`: EAGLE-3 and MTP through
`utils.eagle3_generate_step`, DFlash through `dflash.py`, its tree verify
through `ddtree.py`; `split.py` extracts MTP heads from checkpoints)."""

from .utils import load_drafter, run_speculative_rounds, speculative_generate_step

__all__ = ["run_speculative_rounds", "speculative_generate_step", "load_drafter"]
