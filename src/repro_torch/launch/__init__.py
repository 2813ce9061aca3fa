"""Entry points: ``python -m repro_torch.launch.serve`` serves a request
stream; ``repro_torch.launch.report`` renders saved metrics and workload
records."""
