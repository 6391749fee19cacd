"""Traffic generators: a mix's parameters and a run's seed to a flow table."""
