"""The benchmark of ``gslm_tpu_torch`` on NVIDIA H100s: ``run.py`` runs one
cell of ``BENCHMARK.json`` (a configuration under a mix) once."""
