"""The model stack on PyTorch: the GNN neighbour samplers and models
(``gnn``), DCN-v2 and its EmbeddingBag (``recsys``), and the decoder-only
transformer with its layers and mixture of experts."""
