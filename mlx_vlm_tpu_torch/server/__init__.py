"""The port's OpenAI-compatible HTTP server (python -m mlx_vlm_tpu_torch server)."""
