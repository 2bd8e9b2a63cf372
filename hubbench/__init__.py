"""hubbench: the benchmark of embeddinghub_tpu_torch (see README.md)."""
