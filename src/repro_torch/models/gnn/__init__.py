"""GNN data: neighbour samplers (the BARQ engine as the data pipeline)."""
