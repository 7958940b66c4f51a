"""Adapters for inference (trainer/lora.py); training waits for its own
port."""
