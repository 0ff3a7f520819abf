"""The benchmark of chalametpir_tpu_torch; `python3 pirbench/run.py --help`."""
