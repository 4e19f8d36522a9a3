"""The paper's figures from the port: each module is the twin of the JAX
package's ``benchmarks/<name>.py`` and runs as ``python -m
repro_torch.benchmarks.<name>``."""
