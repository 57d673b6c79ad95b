"""The benchmark of slimt_tpu_torch: one cell a run, driven by BENCHMARK.json.

Run one cell from the root of a checkout:

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
`configs/<name>.json`, the file of the configuration's architecture that
its "reference" key names (`reference/<name>.py`: the plain reference,
the weights' layout and planted settings, each phase's work count), its
traffic mix in `traffic/<name>.json`, the mix's lane in `lanes/<lane>.py`,
its correctness limits in `cells/<name>.json`, each metric's reader in
`metrics/<name>.py` and each phase in `work/<phase>.py`.
The plain reference in `reference/` imports neither JAX nor the port.
"""
