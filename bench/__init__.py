"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once and prints one JSON line.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell sits in a file of its own that the harness finds by name:

- ``bench/configs/<config>.json``: the deployment (its ``kind`` names the
  runner ``bench/kinds/<kind>.py``; its ``generator`` names the data maker
  ``bench/data/<generator>.py``);
- ``bench/traffic/<traffic>.json``: the mix's parameters, read by the one
  generator of the kind (``bench/querygen.py`` for ``aqp``);
- ``bench/metrics/<metric>.py``: a reader of one metric;
- ``bench/limits/<cell>.json``: the limits that decide ``correct``.

The yardstick (traffic, data, the reference, the roofline arithmetic, the
trace reduction) lives here; from the port it takes only the system under
test and its counters. Nothing here imports JAX or the JAX package.
"""
