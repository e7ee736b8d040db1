"""Traffic generation: synthetic scores and the subgraph sampler."""
