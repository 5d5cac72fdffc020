"""The port's benchmark: TPC-H cells served over the port's MySQL wire
server on one NVIDIA card.  `python3 benchmark/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>` runs one cell once."""
