"""Training: AdamW (``optimizer``), checkpointing (``checkpoint``), the
fault-tolerant loop (``trainer``) and trees of tensors (``tree``)."""
