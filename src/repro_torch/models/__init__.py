"""The model stack on PyTorch: the GNN neighbour samplers (``gnn``), and
the decoder-only transformer with its layers and mixture of experts."""
