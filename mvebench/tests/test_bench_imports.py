"""Nothing the harness, its drivers, readers or references import has the
top-level name jax, jaxlib, flax or mve_tpu (compared whole, so
mve_tpu_torch passes), and the references import nothing of the program."""

import subprocess
import sys

from mvebench.harness import bench

CODE = """
import importlib.util, sys
sys.path.insert(0, {root!r})
from mvebench.harness import bench
for kind in {kinds!r}:
    for path in sorted((bench.HERE / kind).glob("*.py")):
        if path.name != "__init__.py":
            bench.load_module(kind, path.stem)
{extra}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(kinds, extra=""):
    out = subprocess.run([sys.executable, "-c", CODE.format(root=str(bench.ROOT), kinds=kinds,
                                                            extra=extra)],
                         capture_output=True, text=True, check=True).stdout
    return set(eval(out.strip().splitlines()[-1]))


def test_harness_loads_no_jax():
    mods = loaded(("drivers", "metrics", "reference"),
                  extra="import mvebench.harness.trace, mvebench.controls\n"
                        "import mve_tpu_torch.apps.dmrecon, mve_tpu_torch.apps.fssrecon")
    assert not mods & set(bench.FORBIDDEN_MODULES)


def test_references_import_nothing_of_the_program():
    mods = loaded(("reference",))
    assert not mods & set(bench.FORBIDDEN_MODULES) and "mve_tpu_torch" not in mods
