"""The share of the traced window in which no operation ran on the
device: device_idle_pct.dmrecon's reading, in the sfmrecon cell."""

from mvebench.harness.bench import load_module

UNIT = "%"
LAYER = "device"
MOVES = "sfmrecon_pairs_per_s"

read = load_module("metrics", "device_idle_pct.dmrecon").read
