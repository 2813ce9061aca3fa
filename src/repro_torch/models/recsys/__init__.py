"""Recommendation models: EmbeddingBag (``embedding``) and DCN-v2 (``dcn``)."""
