"""GNNs: neighbour samplers (the BARQ engine as the data pipeline), the
message-passing primitives (``common``) and the four models (``models``)."""
