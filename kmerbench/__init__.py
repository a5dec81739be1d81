"""kmerbench: the benchmark of aindex_torch's batched k-mer queries.

``python3 kmerbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one
JSON line (see README.md). Configurations, traffic mixes, metric readers
and kernel roofline counts are files found by name; nothing here imports
JAX or the JAX package.
"""
