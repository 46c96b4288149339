"""The most device memory the program held during the window:
device_peak_gb.dmrecon's reading, in the sfmrecon cell."""

from mvebench.harness.bench import load_module

UNIT = "GB"
LAYER = "device"
MOVES = "sfmrecon_pairs_per_s"

read = load_module("metrics", "device_peak_gb.dmrecon").read
