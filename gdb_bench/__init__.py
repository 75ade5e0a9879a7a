"""The benchmark of genomicsdb_tpu_torch on one NVIDIA H100 (see
README.md): `python3 -m gdb_bench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`."""
