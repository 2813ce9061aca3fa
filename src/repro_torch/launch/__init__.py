"""Entry points: ``python -m repro_torch.launch.train`` trains a model
(``launch/steps.py`` builds each cell's step); ``python -m
repro_torch.launch.serve`` serves a request stream; ``python -m
repro_torch.launch.report`` renders dry-run records, bench files, one
query's telemetry, saved metrics and workload records;
``python -m repro_torch.launch.engine_dryrun`` writes the distributed
join's roofline record (``launch/roofline.py`` holds the card's peaks)."""
