"""The benchmark of clpathtracer_tpu_torch: one command runs one cell of
BENCHMARK.json once (run.py); harness/ drives the port, reference/ is the
plain PyTorch reference that decides `correct`, metrics/ holds one reader
per metric, configs/, traffic/ and limits/ the data of each configuration,
traffic mix and cell."""
