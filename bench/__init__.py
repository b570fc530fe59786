"""The port's benchmark: wall-clock TTFT and quality of ``repro_torch``
serving reused documents from its DRAM/SSD hierarchy (see README.md)."""
