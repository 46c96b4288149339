"""Command-line tools mirroring the reference apps (reference: apps/).

Each module is runnable as ``python -m mve_tpu_torch.apps.<name>`` and
exposes a library entry point so pipelines and tests can drive it
without a subprocess.
"""
